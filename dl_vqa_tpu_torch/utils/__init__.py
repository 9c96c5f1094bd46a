"""Utilities of the port: the JAX weight bridge and the npz reader."""
