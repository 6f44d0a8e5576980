"""Synthetic data of the port's sequence track (``tokens``)."""
