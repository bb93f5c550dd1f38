"""Across devices: ranks and meshes, table and ray sharding, the tiles
mesh with ADMM pose consensus and its sync round."""
