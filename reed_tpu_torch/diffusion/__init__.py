"""Interpolant paths and samplers."""
