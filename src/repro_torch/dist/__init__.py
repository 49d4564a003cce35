"""Train steps and the multi-card layout (torch port of ``repro.dist``):
``grad_sync`` (dense and compressed-pod steps) and ``sharding`` (logical
axis rules, spec trees, their DTensor realisation). Neither is imported
here: the model modules import ``sharding`` alone, and ``grad_sync``
imports the FL engine, which must not load the models' dependencies
first."""

__all__ = ["grad_sync", "sharding"]
