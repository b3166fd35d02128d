"""Serving stack (PyTorch): cost model, serve cache, user arena, engine."""
from repro_torch.serve.cache import build_serve_params, serve_state_bytes
from repro_torch.serve.cost_model import (LayerDecision, crossover_batch,
                                          decide, decision_table, mode_costs,
                                          plan_params)
from repro_torch.serve.engine import ServeEngine, load_fl_checkpoint
from repro_torch.serve.user_arena import UserArena, inject_users

__all__ = ["LayerDecision", "ServeEngine", "UserArena", "build_serve_params",
           "crossover_batch", "decide", "decision_table", "inject_users",
           "load_fl_checkpoint", "mode_costs", "plan_params",
           "serve_state_bytes"]
