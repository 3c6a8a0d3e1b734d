"""Taiga data model and transaction layer (L1/L2/L4 of SURVEY.md §1)."""
