"""The weights recurrentgemma-2b's engine tests serve in both packages:
``repro``'s init (key 0) with every block's output projection scaled by
``BLOCK_GAIN``, carried to the port by ``bridge``.  At the plain smoke
init the tied, scaled embedding dominates the residual stream, so every
greedy stream repeats its prompt's last token whatever the recurrent state
holds; with the gain the streams move from token to token and depend on
the state.  The port scales its own trees with
``repro_torch.models.transformer.scale_block_outputs``."""

import jax
import numpy as np

from repro.models import transformer as JTF
from repro_torch.bridge import params_from_numpy
from repro_torch.models.transformer import BLOCK_OUTPUTS

BLOCK_GAIN = 8.0


def gained_weights(jcfg, tcfg):
    """(``repro``'s tree for ``jcfg``, the port's copy of it for ``tcfg`` on
    the CPU), every block's output projection times ``BLOCK_GAIN``."""
    jp = jax.tree_util.tree_map_with_path(
        lambda path, leaf: leaf * BLOCK_GAIN if path[-1].key in BLOCK_OUTPUTS else leaf,
        jax.jit(JTF.init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
