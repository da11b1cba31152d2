"""Metrics, predictive summaries and dataset helpers."""
