"""Record the dropout masks the JAX package and the port draw, for the
tests that hold them equal."""

import jax


def recorded_masks(monkeypatch):
    """Record the dropout masks both packages draw: flax's (from
    ``jax.random.bernoulli``, tracers inside a ``jit``) and the port's
    (from its ``threefry`` wrapper)."""
    import lisec_tpu_torch.models.common as common
    jax_masks, port_masks = [], []
    jax_bernoulli, port_mask = jax.random.bernoulli, common.bernoulli_mask

    def jax_rec(*args, **kwargs):
        jax_masks.append(jax_bernoulli(*args, **kwargs))
        return jax_masks[-1]

    def port_rec(*args, **kwargs):
        port_masks.append(port_mask(*args, **kwargs))
        return port_masks[-1]
    monkeypatch.setattr(jax.random, "bernoulli", jax_rec)
    monkeypatch.setattr(common, "bernoulli_mask", port_rec)
    return jax_masks, port_masks
