"""Scoring models: BM25, vector similarity."""
