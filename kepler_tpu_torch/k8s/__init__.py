"""Kubernetes integration (reference ``internal/k8s/``)."""
