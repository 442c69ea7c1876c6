"""The JAX package's examples as runnable modules of the port:

    python -m tpufem_torch.examples.<name> [flags]    # on the card
    python -m tpufem_torch.examples.<name> [flags] --device cpu

Each ``main(argv=None)`` parses the JAX example's flags with its defaults
(the TPU-only ``--interpret``, ``--no-aot`` and ``--no-pallas`` are not
ported; ``--matvec pallas`` is ``--matvec cuda``) plus ``--device``,
prints what the JAX example prints, and returns a dict of its numbers and
its solution.  Where the JAX example computes in JAX's default float
(fp32 unless x64 is enabled), the port computes in torch's default dtype
(fp32 unless ``torch.set_default_dtype`` says otherwise).
"""
