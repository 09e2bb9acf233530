"""CPU and card tests of the benchmark (not part of the tier-1 suite)."""
