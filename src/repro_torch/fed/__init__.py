"""Flat-space FL round substrate, fused round, server and simulation
harness (torch port of ``repro.fed``)."""
