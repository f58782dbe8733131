"""Serving: continuous-batching engine and token sampling."""
