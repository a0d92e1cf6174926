"""The JAX package's ``Onsager`` on a subset electrolyte, beside the port.

Run from the repository root, on the CPU::

    JAX_PLATFORMS=cpu python scripts/onsager_subset_reference.py

The system: 2,000 ions with charges +1 and -1 tiled as ``bench.py``
tiles them, each an independent random walker of N(0, 0.3) A steps per
frame and axis, wrapped into a 30 A cube as float32, 41 frames 1 ps
apart, so D = 0.3^2 / 2 = 0.045 A^2/ps.  Groups ``[atoms[0::2],
atoms[1::2]]``, ``temperature=300``, the default fits (log-log, slope
pinned to 1).  For ``unwrap=True`` and ``unwrap=False`` it prints, for
the JAX class (streaming float32) and for the port (on the CPU), D_i,
the conductivity, the Nernst-Einstein conductivity and e^2 N_A sum_i
z_i^2 L_ii^self by hand.  With ``unwrap=True`` the JAX class gathers
the first atoms of the universe instead of each group's (ROADMAP Queue
3, item 7); with ``unwrap=False`` both measure wrapped jumps.
"""

import os
import sys
import warnings

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

N_IONS, N_FRAMES, BOX, STEP = 2000, 41, 30.0, 0.3
E_CHARGE, AVOGADRO = 1.602176634e-19, 6.02214076e23


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from mdhelper_tpu.analysis import base as jax_base
    from mdhelper_tpu.analysis.transport import Onsager as JaxOnsager
    from mdhelper_tpu.core.universe import Universe as JaxUniverse

    from mdhelper_tpu_torch.analysis.transport import Onsager
    from mdhelper_tpu_torch.core.universe import Universe

    rng = np.random.default_rng(2032)
    walk = rng.random((N_IONS, 3)) * BOX + np.cumsum(
        rng.normal(0.0, STEP, (N_FRAMES, N_IONS, 3)), axis=0)
    frames = np.mod(walk, BOX).astype(np.float32)
    dims = np.array([BOX] * 3 + [90.0] * 3)
    charges = np.tile([1.0, -1.0], N_IONS // 2)
    jax_base.SerialAnalysisBase._coord_dtype = np.float32
    universes = {
        "JAX": (JaxUniverse.from_arrays(frames.astype(np.float64), dims,
                                        charges=charges), JaxOnsager, {}),
        "port": (Universe.from_arrays(frames, dims, charges=charges),
                 Onsager, {"device": "cpu"}),
    }
    for unwrap in (True, False):
        for name, (u, cls, extra) in universes.items():
            ons = cls([u.atoms[0::2], u.atoms[1::2]], temperature=300,
                      unwrap=unwrap, verbose=False, **extra).run()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                ons.calculate_transport_coefficients()
                ons.calculate_conductivity()
                ons.calculate_nernst_einstein_conductivity()
            hand = (E_CHARGE**2 * AVOGADRO
                    * (ons._charges**2 * ons.results.L_ii_self[0]).sum())
            print(f"unwrap={unwrap} {name}: D_i {ons.results.D_i[0]} A^2/ps;"
                  f" kappa {ons.results.conductivities[0]:.4e}, kappa_NE "
                  f"{ons.results.ne_conductivities[0]:.4e} C^2/(kJ A ps) "
                  f"(e^2 N_A sum z^2 L_ii^self by hand {hand:.4e})")


if __name__ == "__main__":
    main()
