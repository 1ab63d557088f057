"""The jobs a traffic mix names by its ``kind``: train, eval, serve."""
