"""The port's analysis passes: the lock-discipline pass (RACE001-004)."""
