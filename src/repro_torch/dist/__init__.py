"""Per-leaf planning (LayerPlan) and shape-bucketed Newton-Schulz dispatch."""
