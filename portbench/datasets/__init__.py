"""Input generators, one file a dataset kind: ``make(spec, seed, device)``."""
