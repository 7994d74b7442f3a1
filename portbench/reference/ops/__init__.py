"""Plain operations of the reference."""
