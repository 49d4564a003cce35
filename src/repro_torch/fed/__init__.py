"""Flat-space FL round substrate, fused round, server and simulation
harness, the real-model per-leaf round and its mesh scan (torch port of
``repro.fed``, with the reference's exports)."""
from repro_torch.fed.client import make_local_trainer
from repro_torch.fed.engine import (ClientUpdateSpec, MeshSimScan, SimScan,
                                    aggregate_updates, compress_merge_leaf,
                                    init_mesh_residuals,
                                    make_masked_local_trainer,
                                    make_mesh_sim_scan, make_sim_scan,
                                    spec_for)
from repro_torch.fed.mesh_round import (make_fl_round_step,
                                        make_mesh_round_step,
                                        make_round_body)
from repro_torch.fed.round_step import FusedRoundStep, make_round_step
from repro_torch.fed.server import FLServer
from repro_torch.fed.simulation import (FLSimConfig, FLSimResult,
                                        mlp_accuracy, mlp_init, mlp_loss,
                                        plan_cohort, run_fl, run_fl_traced)

__all__ = ["make_local_trainer", "FLServer", "make_fl_round_step",
           "make_mesh_round_step", "make_round_body",
           "make_round_step", "make_masked_local_trainer", "FusedRoundStep",
           "ClientUpdateSpec", "spec_for", "aggregate_updates",
           "compress_merge_leaf", "make_sim_scan", "SimScan",
           "make_mesh_sim_scan", "MeshSimScan",
           "init_mesh_residuals", "FLSimConfig", "FLSimResult", "run_fl",
           "run_fl_traced", "plan_cohort", "mlp_init", "mlp_loss",
           "mlp_accuracy"]
