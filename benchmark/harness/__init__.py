"""The benchmark's harness: it finds a cell's files by name, draws the
inputs from the seed, drives the program for the measured window, reads the
per-layer metrics and decides ``correct`` against the plain reference."""
