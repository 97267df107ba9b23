"""Analysis tools over error files and variant runs."""
