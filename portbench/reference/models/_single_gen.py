"""Machine-generated cart-pole dynamics for PyTorch — do not edit.

Generated by ``python -m cartpole_tpu_torch.symbolic.generate`` from the
SymPy Euler-Lagrange derivation in ``symbolic/lagrangian.py``;
the same CSE feeds ``csrc/single_dynamics.cuh``. Counterpart of
``cartpole_tpu/models/_single_gen.py``.
"""

import torch


N_Q = 2
STATE_DIM = 4

def single_dynamics_core(params, x, u, forces=None):
    """Continuous-time dynamics, rows-out: returns the tuple (qd_0, ..., qdd_0, ...).

    x = [b_x, th_1, b_v, th_1_v]; params = (m_b, m_1, l_1, g, mu_b, v_mu_b, c_d_1, x_s, k_s);
    forces = (f_b_x, f_b_y, f_m_x, f_m_y) or None."""
    m_b, m_1, l_1, g, mu_b, v_mu_b, c_d_1, x_s, k_s = params
    b_x = x[0]
    th_1 = x[1]
    b_v = x[2]
    th_1_v = x[3]
    if forces is None:
        f_b_x, f_b_y, f_m_x, f_m_y = 0.0, 0.0, 0.0, 0.0
    else:
        f_b_x = forces[0]
        f_b_y = forces[1]
        f_m_x = forces[2]
        f_m_y = forces[3]
    x0 = torch.sin(th_1)
    x1 = l_1*x0
    x2 = torch.cos(th_1)
    x3 = l_1*m_1*x2
    x4 = x0**2
    x5 = th_1_v**2
    x6 = l_1**2
    x7 = x5*x6
    x8 = x2**2
    x9 = b_v**2 - 2*b_v*th_1_v*x1 + x4*x7 + x7*x8
    x10 = torch.sqrt(torch.where(x9 > 0, x9, 1.0))
    x11 = (1/2)*c_d_1*x10
    x12 = th_1_v*x11*x6
    x13 = (x9 > 0)
    x14 = -f_m_x*x1 + f_m_y*l_1*x2 - g*x3 + torch.where(x13, (1/2)*b_v*c_d_1*l_1*x0*x10 - x12*x4 - x12*x8, 0)
    x15 = m_1*x8
    x16 = x0/(l_1*m_b + l_1*x15)
    x17 = m_1*m_b
    x18 = m_1**2*x8
    x19 = g*mu_b*torch.tanh(b_v/torch.clamp_min(v_mu_b, 1e-06))
    x20 = f_b_x + f_m_x + k_s*torch.clamp_min(-b_x - x_s, 0.0) - k_s*torch.clamp_min(b_x - x_s, 0.0) - m_1*x19 - m_b*x19 + u + x3*x5 + torch.where(x13, -b_v*x11 + (1/2)*c_d_1*l_1*th_1_v*x0*x10, 0)
    qdd_0 = x14*x16 + x20*(m_1*x4 + m_b + x15)/(m_b**2 + x17*x8 + x17 + x18)
    qdd_1 = x14*(m_1 + m_b)/(x17*x6 + x18*x6) + x16*x20
    return (b_v, th_1_v, qdd_0, qdd_1)


def single_dynamics_jac_core(params, x, u, forces=None):
    """Rows-out dynamics + analytic Jacobians: returns (x_dot_rows, J_x_rows, J_u_rows) as nested tuples. Constant entries are Python literals 0.0/1.0 so downstream chain-rule products fold them.

    x = [b_x, th_1, b_v, th_1_v]; params = (m_b, m_1, l_1, g, mu_b, v_mu_b, c_d_1, x_s, k_s);
    forces = (f_b_x, f_b_y, f_m_x, f_m_y) or None."""
    m_b, m_1, l_1, g, mu_b, v_mu_b, c_d_1, x_s, k_s = params
    b_x = x[0]
    th_1 = x[1]
    b_v = x[2]
    th_1_v = x[3]
    if forces is None:
        f_b_x, f_b_y, f_m_x, f_m_y = 0.0, 0.0, 0.0, 0.0
    else:
        f_b_x = forces[0]
        f_b_y = forces[1]
        f_m_x = forces[2]
        f_m_y = forces[3]
    x0 = torch.sin(th_1)
    x1 = l_1*x0
    x2 = torch.cos(th_1)
    x3 = l_1*x2
    x4 = m_1*x3
    x5 = b_v**2
    x6 = th_1_v*x1
    x7 = x0**2
    x8 = th_1_v**2
    x9 = l_1**2
    x10 = x8*x9
    x11 = x2**2
    x12 = -2*b_v*x6 + x10*x11 + x10*x7 + x5
    x13 = torch.sqrt(torch.where(x12 > 0, x12, 1.0))
    x14 = (1/2)*c_d_1
    x15 = x13*x14
    x16 = th_1_v*x9
    x17 = x16*x7
    x18 = x11*x16
    x19 = (x12 > 0)
    x20 = -f_m_x*x1 + f_m_y*l_1*x2 - g*x4 + torch.where(x19, (1/2)*b_v*c_d_1*l_1*x0*x13 - x15*x17 - x15*x18, 0)
    x21 = m_1*x11
    x22 = l_1*m_b + l_1*x21
    x23 = (1.0/(x22))
    x24 = x0*x23
    x25 = b_x - x_s
    x26 = -b_x - x_s
    x27 = g*m_1
    x28 = (1.0/(torch.clamp_min(v_mu_b, 1e-06)))
    x29 = torch.tanh(b_v*x28)
    x30 = mu_b*x29
    x31 = g*m_b
    x32 = b_v*x15
    x33 = f_b_x + f_m_x - k_s*torch.clamp_min(x25, 0.0) + k_s*torch.clamp_min(x26, 0.0) + u - x27*x30 - x30*x31 + x4*x8 + torch.where(x19, (1/2)*c_d_1*l_1*th_1_v*x0*x13 - x32, 0)
    x34 = m_1*x7
    x35 = m_b + x21 + x34
    x36 = m_1*m_b
    x37 = m_1**2
    x38 = x11*x37
    x39 = m_b**2 + x11*x36 + x36 + x38
    x40 = x35/x39
    x41 = x36*x9 + x38*x9
    x42 = m_1 + m_b
    x43 = x42/x41
    x44 = -k_s*torch.where((x25 < 0), 0.0, torch.where((x25 == 0), 0.5, torch.full_like(x25, 1.0))) - k_s*torch.where((x26 < 0), 0.0, torch.where((x26 == 0), 0.5, torch.full_like(x26, 1.0)))
    x45 = x2*x23
    x46 = 2*x3*x34/x22**2
    x47 = th_1_v*x3
    x48 = (1.0/(x13))
    x49 = x14*x48
    x50 = x49*x5
    x51 = x0*x2
    x52 = b_v*x49
    x53 = -m_1*x1*x8 + torch.where(x19, -x10*x51*x52 + x15*x47 + x47*x50, 0)
    x54 = 2*x51
    x55 = x37*x54
    x56 = l_1**3*x52*x8
    x57 = -f_m_x*x3 - f_m_y*x1 + g*l_1*m_1*x0 + torch.where(x19, -x16*x50*x51 + x2**3*x56 + x2*x56*x7 + x3*x32, 0)
    x58 = x1*x15
    x59 = b_v*x1
    x60 = b_v - x6
    x61 = x49*x60
    x62 = torch.where(x19, -x17*x61 - x18*x61 + x58 + x59*x61, 0)
    x63 = mu_b*x28*(1 - x29**2)
    x64 = -x27*x63 - x31*x63 + torch.where(x19, (1/2)*c_d_1*l_1*th_1_v*x0*x48*x60 - x15 - x52*x60, 0)
    x65 = x17 + x18 - x59
    x66 = x49*x65
    x67 = 2*th_1_v*x4 + torch.where(x19, -x52*x65 + x58 + x6*x66, 0)
    x68 = x15*x9
    x69 = torch.where(x19, (1/2)*b_v*c_d_1*l_1*x0*x48*x65 - x11*x68 - x17*x66 - x18*x66 - x68*x7, 0)
    qdd_0 = x20*x24 + x33*x40
    qdd_1 = x20*x43 + x24*x33
    dq0_x0 = x40*x44
    dq0_x1 = x20*x45 + x20*x46 + x24*x57 + x33*x35*(x36*x54 + x55)/x39**2 + x40*x53
    dq0_x2 = x24*x62 + x40*x64
    dq0_x3 = x24*x69 + x40*x67
    dq0_u = x40
    dq1_x0 = x24*x44
    dq1_x1 = x20*x42*x55*x9/x41**2 + x24*x53 + x33*x45 + x33*x46 + x43*x57
    dq1_x2 = x24*x64 + x43*x62
    dq1_x3 = x24*x67 + x43*x69
    dq1_u = x24
    x_dot = (b_v, th_1_v, qdd_0, qdd_1)
    J_x = (
        (0.0, 0.0, 1.0, 0.0),
        (0.0, 0.0, 0.0, 1.0),
        (dq0_x0, dq0_x1, dq0_x2, dq0_x3),
        (dq1_x0, dq1_x1, dq1_x2, dq1_x3),
    )
    J_u = (0.0, 0.0, dq0_u, dq1_u)
    return x_dot, J_x, J_u
