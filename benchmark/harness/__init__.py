"""The benchmark's general code: nothing in it belongs to one cell."""
