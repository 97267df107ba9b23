"""Data loading: host-side frame -> Cloud bridges."""
