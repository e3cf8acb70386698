"""Primitive colliders and the ground plane (collide/primitives.py)."""
