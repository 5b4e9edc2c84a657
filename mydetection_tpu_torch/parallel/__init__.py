"""Data-parallel helpers of the port."""
