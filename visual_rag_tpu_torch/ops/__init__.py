"""Scoring ops of the port."""
