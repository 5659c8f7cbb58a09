"""H100 constants, the k-core sweep's roofline cost model, and the dry-run's
tally of a traced call with its roofline terms."""
