"""Traversability CNN."""
