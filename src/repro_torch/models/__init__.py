"""Shared model components of the port."""
