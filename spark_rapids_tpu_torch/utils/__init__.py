"""Helpers of the port that belong to no one module."""
