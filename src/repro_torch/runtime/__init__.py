"""Serving helpers of the port."""
