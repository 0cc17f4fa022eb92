"""Point-cloud post-processing pipelines."""
