"""A pytest plugin that starts every test file of a process with empty JAX
caches and freshly built Pallas calls.

The JAX package's Pallas tests run their kernels under
``pltpu.force_tpu_interpret_mode()`` (``test_pallas_gru.py``,
``test_pallas_beam.py``, ``test_ctc_pallas.py``, ...). ``pl.pallas_call``
reads that mode when it is built, and the package keeps the calls it builds
in ``functools.lru_cache``s (``_build_fwd_xf`` and the like): a later file
in the same process that asks for the same shapes gets a call whose kernel
runs in host callbacks, which dispatch JAX ops of their own, and the process
can deadlock when it dispatches its next op while a callback runs.
``test_pallas_gru.py`` then ``test_quant_gru.py`` in one xdist worker
stopped that way in
``test_model_int8_proj_close_to_f32_and_train_ignores_it``. Which files
share a worker under ``--dist loadfile`` changes from run to run, so at each
change of file this clears the package's cached Pallas calls and JAX's
caches.

The port's test files that call the JAX package load this plugin through
``pytest_plugins``; each xdist worker collects all of them, so it is active
in every worker.
"""

import sys

import jax


def clear_jax_state() -> None:
    """Clear every ``functools.lru_cache`` of the loaded ``tpuasr`` modules
    (those that keep built Pallas calls among them), then JAX's own caches."""
    for name, mod in list(sys.modules.items()):
        if mod is None or not (name == "tpuasr" or name.startswith("tpuasr.")):
            continue
        for obj in list(vars(mod).values()):
            if callable(getattr(obj, "cache_clear", None)) and hasattr(
                    obj, "cache_info"):
                obj.cache_clear()
    jax.clear_caches()


def pytest_runtest_teardown(item, nextitem):
    if nextitem is None or nextitem.path != item.path:
        clear_jax_state()
