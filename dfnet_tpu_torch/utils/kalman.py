"""Kalman smoothing of pose trajectories (port of dfnet_tpu/utils/kalman.py).

A Rauch-Tung-Striebel smoother with the reference's model (its
utils.py:333-394, dead code there: the pykalman import is commented out):
scalar random-walk state, transition 1, transition covariance 0.1,
observation covariance `damping`, initial mean the first observation.
Host-side numpy in float64, the JAX package's recursion step for step, so
both packages return the same bits.
"""

from __future__ import annotations

import numpy as np


def _rts_smooth_1d(obs: np.ndarray, damping: float = 1.0,
                   transition_cov: float = 0.1) -> np.ndarray:
    """Forward Kalman filter + backward RTS smoother for a random-walk
    scalar state."""
    n = len(obs)
    m_f = np.zeros(n)       # filtered means
    p_f = np.zeros(n)       # filtered covariances
    m_p = np.zeros(n)       # predicted means
    p_p = np.zeros(n)       # predicted covariances

    m_f[0] = obs[0]
    p_f[0] = damping
    m_p[0] = m_f[0]
    p_p[0] = p_f[0]
    for t in range(1, n):
        m_p[t] = m_f[t - 1]
        p_p[t] = p_f[t - 1] + transition_cov
        k = p_p[t] / (p_p[t] + damping)
        m_f[t] = m_p[t] + k * (obs[t] - m_p[t])
        p_f[t] = (1 - k) * p_p[t]

    m_s = m_f.copy()
    p_s = p_f.copy()
    for t in range(n - 2, -1, -1):
        g = p_f[t] / (p_f[t] + transition_cov)
        m_s[t] = m_f[t] + g * (m_s[t + 1] - m_f[t])
        p_s[t] = p_f[t] + g * g * (p_s[t + 1] - (p_f[t] + transition_cov))
    return m_s


def Kalman1D(observations: np.ndarray, damping: float = 1.0) -> np.ndarray:
    """Smooth a scalar time series; returns (N, 1) float64."""
    obs = np.asarray(observations, np.float64).reshape(-1)
    return _rts_smooth_1d(obs, damping)[:, None]


def Kalman3D(observations: np.ndarray, damping: float = 1.0) -> np.ndarray:
    """Smooth an (N, 3) trajectory axis by axis; returns (N, 3) float64."""
    obs = np.asarray(observations, np.float64)
    return np.stack([_rts_smooth_1d(obs[:, i], damping) for i in range(3)], 1)
