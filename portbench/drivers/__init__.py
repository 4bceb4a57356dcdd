"""Drivers: one per kind of traffic, named by a traffic file's ``driver``
(``harness`` describes the interface)."""
