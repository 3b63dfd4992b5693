"""Config helpers of the port."""
