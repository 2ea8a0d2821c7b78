"""NAPEL (thesis Ch. 5): performance and energy prediction for dry-run
cells from a design-of-experiments corpus of counted train steps."""
