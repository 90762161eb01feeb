"""Shared neural-net building blocks."""
