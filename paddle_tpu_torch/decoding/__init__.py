"""Decode policies of the port."""
