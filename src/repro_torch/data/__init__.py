"""Synthetic datasets and normalization (numpy, same bits as ``repro.data``)."""
