"""Tiles on one card: ADMM pose consensus and the sync round."""
