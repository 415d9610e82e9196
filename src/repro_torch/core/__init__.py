"""EF21-Muon algorithm core: compressors, error feedback, LMOs, norms,
schedule and the optimizer."""
