"""Seeded traffic: the mixes (``<mix>.json``) and their generators."""
