"""Image output and parameter loading."""
