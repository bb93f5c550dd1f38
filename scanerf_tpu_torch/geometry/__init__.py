"""Mesh file formats."""
