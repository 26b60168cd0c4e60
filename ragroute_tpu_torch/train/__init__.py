"""Offline training: the corpus-router classifier, in torch."""
