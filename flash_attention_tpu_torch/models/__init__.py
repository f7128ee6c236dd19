"""Llama-class model and token sampling."""
