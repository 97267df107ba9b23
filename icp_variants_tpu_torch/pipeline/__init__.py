"""The ICP driver, its configuration and its measures."""
