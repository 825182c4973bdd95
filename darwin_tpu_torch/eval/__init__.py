"""Evaluation tools of the port."""
