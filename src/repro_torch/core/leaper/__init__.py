"""LEAPER (thesis Ch. 6): few-shot transfer of cost models across
platforms."""
