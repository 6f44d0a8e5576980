"""GST core of the port: heads and the historical embedding table."""
