"""Fokker-Planck electron update."""
