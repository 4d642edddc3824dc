"""Launchers and end-to-end examples."""
