"""Multi-block FFD maps (reference set_*_multiFFD equivalents)."""

import jax.numpy as jnp
import numpy as np

from goldfish_jax.design.pipeline import MultiShapeFFD, MultiThicknessFFD
from goldfish_jax.models import plate


def test_multi_thickness_partition_of_unity():
    sys = plate.build(num_el=3, p=2, num_patches=4)
    groups = [dict(patches=[0, 1], num_els=(2, 1, 1), p=(2, 1, 1)),
              dict(patches=[2, 3], num_els=(1, 1, 1), p=(1, 1, 1))]
    th = MultiThicknessFFD(sys, groups)
    h = th(jnp.asarray(th.init_h_ffd(plate.H_TH)))
    mask = np.asarray(sys.stack.cp_mask)
    assert np.abs((np.asarray(h) - plate.H_TH) * mask).max() < 1e-12
    # block independence: perturb block 1 only -> patches 0,1 unchanged
    x = th.init_h_ffd(plate.H_TH)
    x[th.offsets[1]:] *= 2.0
    h2 = np.asarray(th(jnp.asarray(x)))
    assert np.allclose(h2[:2], np.asarray(h)[:2])
    assert (h2[2:] * mask[2:]).max() > 1.9 * plate.H_TH


def test_multi_shape_reproduces_geometry():
    sys = plate.build(num_el=3, p=2, num_patches=4)
    groups = [dict(patches=[0, 1], num_els=(2, 1, 1), p=(2, 1, 1)),
              dict(patches=[2, 3], num_els=(2, 1, 1), p=(2, 1, 1))]
    sh = MultiShapeFFD(sys, groups, opt_fields=(2,))
    cp = sh(jnp.asarray(sh.init_p_ffd()))
    err = float(jnp.max(jnp.abs(cp - sys.cp)
                        * sys.stack.cp_mask[..., None]))
    assert err < 1e-9
