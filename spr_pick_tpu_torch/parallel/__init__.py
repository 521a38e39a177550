"""Spatial parallelism: halo-tiled dense inference over large micrographs."""
