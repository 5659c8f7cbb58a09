"""H100 constants and the k-core sweep's roofline cost model."""
