"""Frozen copies of the port's generators, so the yardstick cannot move
with the program."""
