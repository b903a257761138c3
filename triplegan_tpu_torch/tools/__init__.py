"""The real-data campaign on the port: each module runs as ``python -m
triplegan_tpu_torch.tools.<name>`` and writes its JSON into ``--workdir``.

* ``stats``: the sign test, the paired and two-sample permutation tests
  and the bootstrap TOST equivalence band;
* ``campaign``: the port's CLI as subprocesses, the digits recipe's stage
  commands and what is read back from a train log;
* ``digits_experiment``: Triple-GAN against a supervised classifier on the
  same labels, seed by seed;
* ``seed_campaign``: one recipe over N seeds;
* ``flagset_ab``: two arms that differ in a declared set of config keys;
* ``parity``: a summary of the port against the JAX package's committed
  populations (``docs/assets``), distributionally;
* ``digits_quality``: FID, IS, conditional fidelity and the memorisation
  check of the trained generators.

Every module runs on the card unless ``--device cpu`` is asked for.
"""
