#!/usr/bin/env python3
"""Overlay the C-reference and pinc_tpu total-energy curves on the
langmuirCold thermal-drift protocol (BASELINE.md step 4) and print the
parity criterion.  Inputs: results/c_thermal_curve.npy +
results/pinc_drift_curve.npy.  Writes results/drift_parity.png."""
import os
import sys

import numpy as np
import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
R = os.path.join(HERE, "results")
c = np.load(os.path.join(R, "c_thermal_curve.npy"))
t = np.load(os.path.join(R, "pinc_drift_curve.npy"))


def stats(cv):
    e = cv[1]
    half = len(e) // 2
    m = e[half:].mean()
    per1k = (e[-1] - e[half]) / m / ((len(e) - half) / 1000.0)
    return e[min(1, len(e) - 1)], per1k


fig, ax = plt.subplots(figsize=(7.5, 4.5))
for cv, label, color in ((c, "C reference (f64, 1 core)", "#555555"),
                         (t, "pinc_tpu (f32)", "#0a7d36")):
    e0, per1k = stats(cv)
    ax.plot(cv[0], cv[1] / e0,
            label=f"{label}: {per1k*100:+.3f}%/1k-steps plateau drift",
            lw=1.0, color=color)
ax.set_xlabel("timestep")
ax.set_ylabel("total energy / E(1)")
ax.set_title("langmuirCold.ini 32$^3$, thermal start, 10k steps")
ax.legend(loc="best", fontsize=8)
ax.grid(alpha=0.3)
fig.tight_layout()
out = os.path.join(R, "drift_parity.png")
fig.savefig(out, dpi=130)
ce, cd = stats(c)
te, td = stats(t)
print(f"E(1):  C {ce:.5e}  pinc_tpu {te:.5e}  (ratio {te/ce:.5f})")
print(f"plateau drift: C {cd*100:+.4f}%/1k  pinc_tpu {td*100:+.4f}%/1k")
print("wrote", out)
