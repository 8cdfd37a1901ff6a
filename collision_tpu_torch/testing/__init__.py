from .oracle import brute_force_collisions, kdtree_collisions, pair_array_to_set

__all__ = ["brute_force_collisions", "kdtree_collisions", "pair_array_to_set"]
