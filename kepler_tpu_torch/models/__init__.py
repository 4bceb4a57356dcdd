"""Learned power estimators (linear, MLP) and their parameter files."""
