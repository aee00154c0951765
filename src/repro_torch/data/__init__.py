"""Synthetic datasets (numpy, same bits as ``repro.data``)."""
