"""Small shared utilities of the port."""
