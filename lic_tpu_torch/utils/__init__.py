"""Utilities of the port: native builds, the flax → torch parameter bridge."""
