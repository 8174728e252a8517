"""Geometry: polar coordinates, triangle surfaces and umbrella fans."""
