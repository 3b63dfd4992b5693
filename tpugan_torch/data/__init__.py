"""Dataset helpers and prefetching loaders."""
