"""The plain reference against the port in float64 on the CPU at a tiny
size: the lanes tick, which the port runs on the CPU through the plain
version of kernel 1."""

import math

import numpy as np
import pytest
import torch

import cartpole_tpu_torch as pt
from cartpole_tpu_torch.mpc.lanes import tick_fn_lanes as port_tick
from portbench.reference.models import get_model
from portbench.reference.mpc.config import OptimizationParams
from portbench.reference.mpc.controller import MPC
from portbench.reference.mpc.lanes import tick_fn_lanes as ref_tick

F64 = torch.float64
SMALL = dict(window_length=4, state_spacing=2, max_iterations=4)
DOUBLE = dict(SMALL, th_final_cost_weight=150.0, th_dot_final_cost_weight=10.0,
              b_x_dot_final_cost_weight=10.0, u_guess_sinusoid_amplitude=0.0)


def _states(model, n, upright, seed=0):
    rng = np.random.default_rng(seed)
    x = np.zeros((n, model.state_dim))
    x[:, list(model.angle_indices)] = (math.pi / 2 if upright
                                       else -math.pi / 2)
    x[:, :model.state_dim // 2] += rng.uniform(-0.3, 0.3,
                                               (n, model.state_dim // 2))
    return torch.as_tensor(x, dtype=F64)


@pytest.mark.parametrize("name, kw, upright, grid", [
    ("single", SMALL, False, False),
    ("double", DOUBLE, True, False),
    ("single", SMALL, False, True),
])
def test_lanes_tick_matches_the_port(name, kw, upright, grid):
    n = 5
    pmodel, rmodel = pt.get_model(name), get_model(name)
    pmpc = pt.make_mpc(pt.OptimizationParams(**kw), pmodel)
    rmpc = MPC(OptimizationParams(**kw), rmodel)
    fields = dict(pmodel.params_type().as_dict())
    if grid:
        rng = np.random.default_rng(1)
        fields.update(m_1=rng.uniform(0.05, 0.2, n),
                      l_1=rng.uniform(0.15, 0.4, n))
    pdp = pmodel.params_type(**{k: torch.as_tensor(np.asarray(v), dtype=F64)
                                for k, v in fields.items()})
    rdp = rmodel.params_type(**{k: torch.as_tensor(np.asarray(v), dtype=F64)
                                for k, v in fields.items()})
    sp = torch.zeros(n, dtype=F64)
    pt_tick = port_tick(pmpc, pdp, sp, True, fused=True)
    rf_tick = ref_tick(rmpc, rdp, sp, True)
    carry = (_states(pmodel, n, upright).T.contiguous(),
             torch.zeros((n, pmpc.spec.dim), dtype=F64),
             torch.zeros(n, dtype=torch.bool))
    pc = rc = carry
    for _ in range(3):
        po, ro = pt_tick(*pc), rf_tick(*rc)
        for a, b in zip(po, ro):
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
        pc, rc = po[:3], ro[:3]

