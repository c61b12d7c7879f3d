"""Sparse primitives: CSR row pointers and segment/search operations."""
