"""The weights the recurrent families' engine tests serve in both
packages: ``repro``'s init (key 0) with every block's output projection
scaled by ``BLOCK_GAIN``, carried to the port by ``bridge``.  At the plain
smoke init recurrentgemma-2b's tied, scaled embedding dominates the
residual stream, so every greedy stream repeats its prompt's last token
whatever the recurrent state holds; with the gain the streams move from
token to token and depend on the state.  The port scales its own trees
with ``repro_torch.models.transformer.scale_block_outputs``.

mamba2-1.3b's streams move at the plain init, but its D skip (``d_skip``
= 1, a per-head ``D·x``) outweighs the SSM state's ``C·h`` about a
hundredfold there: zeroing ``ssm_state`` before every decode step changes
3 of 42 greedy tokens of the mixed trace.  Its engine tests also zero
``d_skip`` (``zero=("d_skip",)``): the gated RMS norm after the skip
keeps the output's scale, and the same change then moves 30 of 42."""

import jax
import numpy as np

from repro.models import transformer as JTF
from repro_torch.bridge import params_from_numpy
from repro_torch.models.transformer import BLOCK_OUTPUTS

BLOCK_GAIN = 8.0


def gained_weights(jcfg, tcfg, zero=()):
    """(``repro``'s tree for ``jcfg``, the port's copy of it for ``tcfg`` on
    the CPU), every block's output projection times ``BLOCK_GAIN`` and the
    leaves named in ``zero`` set to 0."""
    def change(path, leaf):
        name = path[-1].key
        if name in zero:
            return leaf * 0
        return leaf * BLOCK_GAIN if name in BLOCK_OUTPUTS else leaf

    jp = jax.tree_util.tree_map_with_path(
        change, jax.jit(JTF.init_lm, static_argnums=1)(jax.random.PRNGKey(0), jcfg))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
