"""Interfaces, model assembly and checkpoint reading."""
