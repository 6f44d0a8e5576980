"""GST core of the port: segment sampling and SED, the historical embedding
table, the heads and the train/eval/refresh/finetune steps."""
