"""Synthetic datasets for the port's tests and smoke run (mirrors
``repro.data``)."""
