"""The port's S3 checkpoint storage against the JAX package's, over the
in-memory fake boto3 of ``tests/test_s3_storage.py`` (the same fixture):
key layout, pagination, 404-vs-error discrimination, the marker protocol
and a save / load / copy lifecycle; and a tag that the JAX package writes
to the fake store loads in the port bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_s3_storage import _ClientError, fake_s3  # noqa: F401  (the fixture)


def test_s3_storage_primitives(fake_s3):  # noqa: F811
    from neuronx_distributed_llama3_2_tpu_torch.checkpoint.storage import (
        create_checkpoint_storage,
    )

    st = create_checkpoint_storage("s3://bucket/ckpts/run1")
    assert type(st).__name__ == "S3CheckpointStorage"
    assert not st.file_exists("x")
    st.save_text("hello", "x")
    assert st.file_exists("x") and st.load_text("x") == "hello"
    st.save_bytes(b"\x00\x01", "tag/a/b.npy")
    assert st.dir_exists("tag")
    for i in range(5):
        st.save_text(str(i), f"tag/f{i}")
    names = st.listdir("tag")
    assert "a" in names and {f"f{i}" for i in range(5)} <= set(names)
    st.remove_dir("tag")
    assert not st.dir_exists("tag")
    assert st.file_exists("x")
    st.remove_file("x")
    assert not st.file_exists("x")


def test_s3_non_404_errors_propagate(fake_s3):  # noqa: F811
    """Throttling must not read as "file missing": the done-marker GC
    would delete valid checkpoints."""
    from neuronx_distributed_llama3_2_tpu_torch.checkpoint.storage import (
        create_checkpoint_storage,
    )

    st = create_checkpoint_storage("s3://bucket/p")

    def throttled(Bucket, Key):
        raise _ClientError(status=503, code="SlowDown")

    st._client.head_object = throttled
    with pytest.raises(_ClientError):
        st.file_exists("anything")


def test_s3_checkpoint_lifecycle(fake_s3):  # noqa: F811
    from neuronx_distributed_llama3_2_tpu_torch.checkpoint import (
        copy_checkpoint,
        load_checkpoint,
        save_checkpoint,
    )

    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": torch.ones(3, dtype=torch.bfloat16)}
    save_checkpoint("s3://bucket/ckpts", tag="t1", model=tree, user_content={"note": "s3"})
    loaded = load_checkpoint("s3://bucket/ckpts", tag="latest", model=tree)
    assert torch.equal(loaded["model"]["w"], tree["w"])
    assert loaded["user_content"] == {"note": "s3"}
    copy_checkpoint("s3://bucket/ckpts", "t1", "s3://bucket/export", "t1x")
    again = load_checkpoint("s3://bucket/export", tag="t1x", model=tree)
    assert torch.equal(again["model"]["b"], tree["b"])


def test_jax_tag_on_s3_loads_in_the_port(fake_s3):  # noqa: F811
    from neuronx_distributed_llama3_2_tpu.checkpoint import save_checkpoint as jax_save
    from neuronx_distributed_llama3_2_tpu_torch.checkpoint import load_checkpoint

    rng = np.random.default_rng(5)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    jax_save("s3://bucket/jax", tag="step_3",
             model={"w": jnp.asarray(w), "b": jnp.asarray(b, jnp.bfloat16)},
             user_content={"step": 3})
    got = load_checkpoint("s3://bucket/jax", tag="latest",
                          model={"w": torch.zeros(3, 4), "b": torch.zeros(5, dtype=torch.bfloat16)})
    assert got["tag"] == "step_3" and got["user_content"] == {"step": 3}
    assert torch.equal(got["model"]["w"], torch.from_numpy(w))
    want_b = np.asarray(jnp.asarray(b, jnp.bfloat16)).view(np.uint16).astype(np.int32)
    assert np.array_equal(got["model"]["b"].view(torch.int16).numpy().view(np.uint16), want_b)


def test_s3_without_boto3_raises_a_clear_error(monkeypatch):
    import sys

    from neuronx_distributed_llama3_2_tpu_torch.checkpoint.storage import (
        create_checkpoint_storage,
    )

    monkeypatch.setitem(sys.modules, "boto3", None)  # import boto3 -> ImportError
    with pytest.raises(ImportError, match="boto3"):
        create_checkpoint_storage("s3://bucket/x")
