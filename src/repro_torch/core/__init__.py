"""Losses and the analytic memory model."""
