"""The range-image segmentation net: the port (on the CPU) vs the JAX
package, at 8 x 64 with the small variant (stage blocks (1, 1, 2, 2)).

- f32: the port's RangeSegmentator carrying the flax variables
  (convert.segmentator_from_flax) gives JAX's logits within 2e-4 and the
  same labels. Random BatchNorm statistics, so no layer is an identity.
- bf16 (flax's default dtype): both sides round every conv's inputs,
  kernels and outputs to bf16 (2^-8 relative), in different places (oneDNN
  vs XLA:CPU accumulation order), and that compounds over the net's 23
  convs: logits within BF16_TOL, labels equal wherever JAX's top-two margin
  is above BF16_TOL.
- the reference's torch darknet state_dicts (the torch mirror of
  tests/test_segmentation_parity.py) load through the port's
  torch_convert and give the mirror's logits within 2e-4;
- crf_refine / segment_with_crf against JAX's (window rolls wrap);
- one training step (f32) against train_segmentator(steps=1): loss within
  1e-5 relative; the parameter updates and the BatchNorm running
  statistics within 1e-6 of JAX's but for at most 5e-4 of the entries,
  which stay within 2 lr: Adam's first step is lr g / (|g| + 1e-8), so
  where |g| is near 1e-8 it turns on the gradient's last bits; a bf16
  step's loss within 1e-3 relative;
- mean_iou and make_synthetic_dataset against JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slide_slam_tpu.frontend import segmentation as jseg
from slide_slam_tpu.frontend import train_segmentation as jtrain
from slide_slam_tpu_torch.convert import segmentator_from_flax
from slide_slam_tpu_torch.frontend import segmentation as tseg
from slide_slam_tpu_torch.frontend import torch_convert
from slide_slam_tpu_torch.frontend import train_segmentation as ttrain

from _torch_parity import one_torch_thread  # noqa: F401
from test_segmentation_parity import TorchSegmentator, _randomize

pytestmark = pytest.mark.usefixtures("one_torch_thread")

H, W, C = 8, 64, 16
STAGES = (1, 1, 2, 2)
F32_TOL = 2e-4
BF16_TOL = 0.1


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _random_variables(dtype, seed=0):
    """The JAX init at (H, W), BatchNorm scale/bias/mean/var and the head
    bias drawn at random (numpy, seeded)."""
    model = jseg.RangeSegmentator(num_classes=C, stage_blocks=STAGES,
                                  dtype=dtype)
    v = _numpy_tree(jseg.init_params(model, jax.random.PRNGKey(seed),
                                     height=H, width=W))
    rng = np.random.default_rng(seed)

    def visit(tree, path=()):
        for k, leaf in tree.items():
            if isinstance(leaf, dict):
                visit(leaf, path + (k,))
            elif k == "scale" or k == "var":
                tree[k] = rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
            elif k == "mean" or k == "bias":
                tree[k] = rng.normal(0, 0.1, leaf.shape).astype(np.float32)
    visit(v)
    return model, v


def _port_model(variables, dtype):
    model = tseg.RangeSegmentator(num_classes=C, stage_blocks=STAGES,
                                  dtype=dtype)
    return segmentator_from_flax(variables, model).eval()


def _input(seed=1, batch=2):
    return np.random.default_rng(seed).normal(
        0, 1, (batch, H, W, 5)).astype(np.float32)


def test_f32_logits_match_jax():
    jm, v = _random_variables(jnp.float32)
    tm = _port_model(v, torch.float32)
    x = _input()
    want = np.asarray(jm.apply(jax.tree_util.tree_map(jnp.asarray, v),
                               jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, H, W, C)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_array_equal(
        tseg.segment(tm, torch.from_numpy(x)).numpy(),
        np.asarray(jseg.segment(jm, jax.tree_util.tree_map(jnp.asarray, v),
                                jnp.asarray(x))))


def test_bf16_logits_match_jax():
    jm, v = _random_variables(jnp.bfloat16)
    tm = _port_model(v, torch.bfloat16)
    x = _input()
    want = np.asarray(jm.apply(jax.tree_util.tree_map(jnp.asarray, v),
                               jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=0)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > BF16_TOL
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


def test_segmentator_from_flax_checks_paths_and_shapes():
    _, v = _random_variables(jnp.float32)
    tm = tseg.RangeSegmentator(num_classes=C, stage_blocks=STAGES,
                               dtype=torch.float32)
    segmentator_from_flax(v, tm)
    head = v["params"]["Conv_0"]["kernel"]
    np.testing.assert_array_equal(tm.Conv_0.weight.detach().numpy(),
                                  np.transpose(head, (3, 2, 0, 1)))
    bad = jax.tree_util.tree_map(lambda a: a, v)
    bad["params"]["Conv_0"]["kernel"] = head[..., :3]
    with pytest.raises(ValueError):
        segmentator_from_flax(bad, tm)
    short = {"params": {"Conv_0": v["params"]["Conv_0"]},
             "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError):
        segmentator_from_flax(short, tm)
    wrong = tseg.RangeSegmentator(num_classes=C, stage_blocks=(1, 1),
                                  dtype=torch.float32)
    with pytest.raises((KeyError, ValueError)):
        segmentator_from_flax(v, wrong)


def test_reference_state_dict_loads_in_flax_order():
    """The torch mirror's state_dict through the port's loader: 21 (conv,
    bn) pairs, the head, and the mirror's logits."""
    gen = torch.Generator().manual_seed(0)
    mirror = TorchSegmentator(num_classes=4).eval()
    _randomize(mirror, gen)
    sd = {k: v.detach().numpy() for k, v in mirror.state_dict().items()}
    tm = tseg.RangeSegmentator(num_classes=4, stage_blocks=STAGES,
                               dtype=torch.float32)
    tm, n = torch_convert.load_torch_weights(tm, sd)
    assert n == 21
    torch_convert.load_head_conv(tm, sd["head.weight"], sd["head.bias"])
    tm.eval()
    x = _input(batch=1)
    with torch.no_grad():
        want = mirror(torch.from_numpy(x).permute(0, 3, 1, 2))
        got = tm(torch.from_numpy(x))
    want = want.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=1e-3)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("learned", [False, True], ids=["potts", "learned"])
def test_crf_refine_matches_jax(learned):
    from slide_slam_tpu.frontend.torch_convert import load_crf_compat
    rng = np.random.default_rng(2)
    n_cls = 6
    xyz = rng.normal(0, 1, (1, H, W, 3)).astype(np.float32)
    logits = rng.normal(0, 1, (1, H, W, n_cls)).astype(np.float32)
    mask = rng.uniform(size=(1, H, W)) > 0.2
    kw = {}
    if learned:
        torch.manual_seed(0)
        conv = torch.nn.Conv2d(n_cls, n_cls, 1)
        sd = {f"CRF.compat_conv.{k}": v.detach().numpy()
              for k, v in conv.state_dict().items()}
        jc, jb = load_crf_compat(sd)
        tc, tb = torch_convert.load_crf_compat(sd)
        np.testing.assert_array_equal(tc.numpy(), jc)
        kw = (dict(compat=jnp.asarray(jc), compat_bias=jnp.asarray(jb)),
              dict(compat=tc, compat_bias=tb))
    sm = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    want = np.asarray(jseg.crf_refine(jnp.asarray(xyz), sm,
                                      jnp.asarray(mask), iters=3,
                                      **(kw[0] if kw else {})))
    got = tseg.crf_refine(torch.from_numpy(xyz),
                          torch.softmax(torch.from_numpy(logits), -1),
                          torch.from_numpy(mask), iters=3,
                          **(kw[1] if kw else {})).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_segment_with_crf_matches_jax():
    jm, v = _random_variables(jnp.float32)
    tm = _port_model(v, torch.float32)
    x = _input(batch=1)
    x[..., 0] = np.abs(x[..., 0])
    x[0, :2, :8, 0] = 0.0                    # invalid pixels
    want = np.asarray(jseg.segment_with_crf(
        jm, jax.tree_util.tree_map(jnp.asarray, v), jnp.asarray(x)))
    got = tseg.segment_with_crf(tm, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def _train_data(seed=3, n=4):
    rng = np.random.default_rng(seed)
    inputs = rng.normal(0, 1, (n, H, W, 5)).astype(np.float32)
    labels = rng.integers(0, C, (n, H, W)).astype(np.int32)
    valid = rng.uniform(size=(n, H, W)) > 0.3
    return inputs, labels, valid


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_one_training_step_matches_jax(dtype):
    """train_segmentator(steps=1) from the JAX package's init in both
    packages: the same batch (numpy default_rng draws), masked
    cross-entropy, batch-statistics BatchNorm, Adam."""
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    inputs, labels, valid = _train_data()
    jm = jseg.RangeSegmentator(num_classes=C, stage_blocks=STAGES, dtype=jdt)
    init = _numpy_tree(jm.init(jax.random.PRNGKey(0),
                               jnp.asarray(inputs[:1]), train=False))
    jv, jmet = jtrain.train_segmentator(jm, inputs, labels, valid, steps=1,
                                        lr=1e-3, batch=2, seed=0)
    jv = _numpy_tree(jv)
    tm = tseg.RangeSegmentator(num_classes=C, stage_blocks=STAGES, dtype=tdt)
    tm, tmet = ttrain.train_segmentator(tm, inputs, labels, valid, steps=1,
                                        lr=1e-3, batch=2, seed=0,
                                        init_variables=init, device="cpu")
    loss_tol = 1e-5 if dtype == "f32" else 1e-3
    assert abs(tmet["final_loss"] - jmet["final_loss"]) \
        <= loss_tol * jmet["final_loss"]
    if dtype != "f32":
        return
    named = dict(tm.named_parameters())
    named.update(tm.named_buffers())
    leaves = {"kernel": "weight", "bias": "bias", "scale": "scale",
              "mean": "mean", "var": "var"}

    def walk(tree, init_tree, path):
        for k, leaf in tree.items():
            if isinstance(leaf, dict):
                walk(leaf, init_tree[k], path + [k])
                continue
            got = named[".".join(path + [leaves[k]])].detach().numpy()
            want, start = leaf, init_tree[k]
            if k == "kernel":
                want = np.transpose(want, (3, 2, 0, 1))
                start = np.transpose(start, (3, 2, 0, 1))
            step_gap = np.abs((got - start) - (want - start))
            name = ".".join(path + [k])
            assert step_gap.max() <= 2e-3 + 1e-6, name
            off.append(int((step_gap > 1e-6).sum()))
            total.append(step_gap.size)
    off, total = [], []
    walk(jv["params"], init["params"], [])
    walk(jv["batch_stats"], init["batch_stats"], [])
    assert sum(off) <= 5e-4 * sum(total), (sum(off), sum(total))


def test_mean_iou_and_dataset_match_jax():
    rng = np.random.default_rng(4)
    pred = rng.integers(0, 5, (3, H, W))
    true = rng.integers(0, 4, (3, H, W))
    valid = rng.uniform(size=(3, H, W)) > 0.2
    assert ttrain.mean_iou(pred, true, valid, 5) == \
        jtrain.mean_iou(pred, true, valid, 5)
    scans = [rng.normal(0, 8, (300, 3)).astype(np.float32) for _ in range(2)]

    def labeler(x):
        return (np.asarray(x)[..., 0] > 8).astype(np.int32)
    want = jtrain.make_synthetic_dataset(scans, [None] * 2, labeler, H, W)
    got = ttrain.make_synthetic_dataset(
        scans, [None] * 2, lambda x: torch.as_tensor(labeler(x.numpy())),
        H, W, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=0)
