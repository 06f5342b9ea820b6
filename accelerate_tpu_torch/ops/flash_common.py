"""The online-softmax contract shared by the port's attention kernels.

Port of `accelerate_tpu/ops/flash_common.py`. Every kernel that streams K/V
blocks keeps three fp32 values per query row, whatever the input dtype:

  - ``m``: the running maximum of the scores seen so far, starting at NEG_INF;
  - ``l``: the running normaliser sum(exp(s - m)), starting at 0;
  - ``acc[D]``: the unnormalised output sum(exp(s - m) * v), starting at 0.

Folding one block of scores ``s`` (already scaled, masked lanes at NEG_INF)
and values ``v``::

    m_new = max(m, max(s))
    p     = exp(s - m_new)
    corr  = exp(m - m_new)
    l     = l * corr + sum(p)
    acc   = acc * corr + p @ v
    m     = m_new

Finalize divides by ``max(l, 1e-30)``: a row whose every lane was masked
comes out ~0, never NaN, which lets inactive serving slots ride the same
launch as live ones.

NEG_INF stays -1e30 and not -inf: exp(NEG_INF - m) is an exact 0 in fp32 and
never produces inf - inf = NaN when a whole block is masked. On the TPU the
per-row ``m``/``l`` rode a 128-lane broadcast axis (a Mosaic tiling artefact);
on Hopper they are one value per row (`csrc/paged_attention.cu` keeps them in
shared memory beside the row's ``acc``).
"""

#: Additive mask value: large enough to zero a softmax lane, small enough that
#: exp(NEG_INF - m) never produces inf/nan under fp32.
NEG_INF = -1e30
