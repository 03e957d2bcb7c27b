"""The port's ``save``/``load`` (``utils/serialize.py``): the JAX
package's round-trip tests (tests/test_serialize.py, after pca.rs:936-947
and ica.rs:422-432) on the port, and archives cross-loaded both ways
between the two packages."""

import io
import json

import numpy as np
import pytest
import torch

import petal_decomposition_tpu as jpd
from petal_decomposition_tpu.utils import serialize as jax_serialize
import petal_decomposition_tpu_torch as pt
from petal_decomposition_tpu_torch.utils import rng as port_rng
from petal_decomposition_tpu_torch.utils import serialize
from petal_decomposition_tpu_torch.utils.serialize import from_bytes, to_bytes

RNG_SEED = 1_234_567_891_011_121_314
CPU = "cpu"
BAND = 1e-12


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _load(data):
    return from_bytes(data, device=CPU)


def test_pca_roundtrip(tmp_path):
    """ref: pca.rs:936-947."""
    x = np.array([[1.0, 1.0]], dtype=np.float32)
    pca = pt.Pca(1, device=CPU).fit(x)
    path = tmp_path / "pca.npz"
    pt.save(pca, path)
    loaded = pt.load(path, device=CPU)
    assert torch.equal(loaded.components(), pca.components())
    assert torch.equal(loaded.mean(), pca.mean())
    assert loaded.device == torch.device(CPU)


def test_pca_roundtrip_transforms_identically():
    x = np.random.default_rng(0).standard_normal((50, 8))
    pca = pt.Pca(3, device=CPU).fit(x)
    loaded = _load(to_bytes(pca))
    assert torch.equal(loaded.transform(x), pca.transform(x))
    assert torch.equal(loaded.explained_variance_ratio(),
                       pca.explained_variance_ratio())


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_randomized_pca_roundtrip_rng_state(dtype):
    """ref: pca.rs:309-315 — the generator's state serializes, so a
    restored model's next fit continues the same stream, bitwise."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((40, 10)).astype(dtype)
    if dtype == np.complex128:
        x = x + 1j * rng.standard_normal((40, 10))
    pca = pt.RandomizedPca(2, seed=RNG_SEED, device=CPU).fit(x)
    blob = to_bytes(pca)
    restored = _load(blob)
    assert torch.equal(restored.transform(x), pca.transform(x))
    pca.fit(x)  # advances the original's stream
    restored.fit(x)  # must draw the same sub-stream
    assert torch.equal(restored.components(), pca.components())
    assert torch.equal(restored.singular_values_, pca.singular_values_)


def test_fast_ica_roundtrip(tmp_path):
    """ref: ica.rs:422-432."""
    x = np.array([[0.0, 0.0], [1.0, 1.0], [1.0, -1.0]])
    ica = pt.FastIca(seed=RNG_SEED, device=CPU).fit(x)
    path = tmp_path / "ica.npz"
    pt.save(ica, path)
    loaded = pt.load(path, device=CPU)
    assert torch.equal(loaded.components(), ica.components())
    assert torch.equal(loaded.transform(x), ica.transform(x))
    assert loaded.n_iter_ == ica.n_iter_
    x2 = np.random.default_rng(2).standard_normal((300, 3))
    assert torch.equal(loaded.fit(x2).components_, ica.fit(x2).components_)


def test_unfitted_model_roundtrip():
    pca = pt.Pca(4, centering=False, device=CPU)
    loaded = _load(to_bytes(pca))
    assert loaded.n_components() == 4
    assert loaded._centering is False
    assert loaded.components() is None


def test_mesh_not_serialized():
    """A mesh is never saved, as in the JAX package: a JAX archive of a
    mesh fit and a port one each load with ``_mesh`` None and transform
    as the fitted model does; the port's archive holds no mesh."""
    import jax

    from petal_decomposition_tpu.parallel import make_mesh
    from petal_decomposition_tpu_torch.parallel import make_mesh as pmesh

    mesh = make_mesh(min(8, len(jax.devices())))
    x = np.random.default_rng(2).standard_normal((64, 6))
    jm = jpd.PcaBuilder(2).mesh(mesh).build().fit(x)
    loaded = _load(jax_serialize.to_bytes(jm))
    assert loaded._mesh is None
    assert _rel(loaded.transform(x), jm.transform(x)) < BAND
    pm = pt.PcaBuilder(2).mesh(pmesh(8, devices=[CPU] * 8)).build().fit(x)
    data = to_bytes(pm)
    with np.load(io.BytesIO(data)) as npz:
        meta = json.loads(bytes(npz["__meta__"].tobytes()).decode("utf-8"))
        assert meta["_mesh"] is None
        assert not any("mesh" in name for name in npz.files)
    loaded = _load(data)
    assert loaded._mesh is None
    assert torch.equal(loaded.transform(x), pm.transform(x))


def _rewrite(data: bytes, edit) -> bytes:
    """The archive with ``edit(meta)`` applied to its JSON header."""
    with np.load(io.BytesIO(data)) as npz:
        meta = json.loads(bytes(npz["__meta__"].tobytes()).decode())
        arrays = {k: npz[k] for k in npz.files if k != "__meta__"}
    edit(meta)
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(json.dumps(meta).encode(),
                                         dtype=np.uint8), **arrays)
    return buf.getvalue()


def test_future_format_version_rejected():
    """A model written by a newer library must load with a clear error,
    not as a silently wrong model."""
    m = pt.Pca(2, device=CPU).fit(
        np.random.default_rng(0).standard_normal((20, 4)))
    data = _rewrite(to_bytes(m), lambda meta: meta.update(
        __format__=serialize._FORMAT_VERSION + 1))
    with pytest.raises(ValueError, match="format v2"):
        _load(data)
    with pytest.raises(ValueError, match="format v"):
        jax_serialize.from_bytes(data)


def test_old_format_missing_fields_backfilled():
    """Archives written before a field existed load with the current
    constructor defaults — transform and refit both work."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((40, 10))

    def strip(*fields):
        return lambda meta: [meta.pop(f, None) for f in fields]

    pca = pt.RandomizedPca(2, seed=RNG_SEED, device=CPU).fit(x)
    loaded = _load(_rewrite(to_bytes(pca),
                            strip("_range_finder", "_gram_precision")))
    assert loaded._range_finder == "auto"
    assert loaded._gram_precision == "auto"
    assert torch.equal(loaded.transform(x), pca.transform(x))
    loaded.fit(x)

    ica = pt.FastIca(seed=RNG_SEED, device=CPU).fit(
        rng.standard_normal((200, 4)))
    loaded = _load(_rewrite(to_bytes(ica), strip("_whiten")))
    assert loaded._whiten is True
    loaded.fit(rng.standard_normal((200, 4)))


# The three models of each package, fitted or not, for cross-loading.
_X = np.random.default_rng(4).standard_normal((120, 6)) @ np.diag(
    [3.0, 2.0, 1.5, 1.0, 0.5, 0.25])
_PAIRS = {
    "Pca": (lambda: jpd.Pca(3), lambda: pt.Pca(3, device=CPU)),
    "Pca_no_centering": (lambda: jpd.Pca(2, centering=False),
                         lambda: pt.Pca(2, centering=False, device=CPU)),
    "RandomizedPca": (lambda: jpd.RandomizedPca(3, seed=RNG_SEED),
                      lambda: pt.RandomizedPca(3, seed=RNG_SEED,
                                               device=CPU)),
    "FastIca": (lambda: jpd.FastIca(seed=RNG_SEED),
                lambda: pt.FastIca(seed=RNG_SEED, device=CPU)),
}


def _same_transform(a, b, x=_X):
    assert _rel(np.asarray(a.transform(x)), np.asarray(b.transform(x))) \
        < BAND


@pytest.mark.parametrize("name", list(_PAIRS))
@pytest.mark.parametrize("fitted", [True, False], ids=["fitted", "unfitted"])
def test_jax_archive_loads_into_port(name, fitted):
    make_jax, _ = _PAIRS[name]
    jm = make_jax()
    if fitted:
        jm.fit(_X)
    pm = _load(jax_serialize.to_bytes(jm))
    assert type(pm) is getattr(pt, type(jm).__name__)
    assert pm.device == torch.device(CPU)
    if not fitted:
        assert pm.components_ is None
        pm.fit(_X)  # an unfitted JAX model's knobs fit in the port
        return
    _same_transform(pm, jm)
    assert _rel(pm.inverse_transform(pm.transform(_X)),
                jm.inverse_transform(jm.transform(_X))) < BAND
    if name != "FastIca":
        assert _rel(pm.singular_values_, jm.singular_values_) < BAND
        assert pm._n_samples == jm._n_samples


@pytest.mark.parametrize("name", list(_PAIRS))
@pytest.mark.parametrize("fitted", [True, False], ids=["fitted", "unfitted"])
def test_port_archive_loads_into_jax(name, fitted):
    _, make_port = _PAIRS[name]
    pm = make_port()
    if fitted:
        pm.fit(_X)
    jm = jax_serialize.from_bytes(to_bytes(pm))
    assert type(jm) is getattr(jpd, type(pm).__name__)
    if not fitted:
        assert jm.components_ is None
        jm.fit(_X)
        return
    _same_transform(pm, jm)
    if name == "FastIca":
        assert jm.n_iter_ == pm.n_iter_
    else:
        assert _rel(np.asarray(jm.explained_variance_ratio_),
                    pm.explained_variance_ratio_) < BAND
    # The JAX package backfills the key from seed=0.
    if name in ("RandomizedPca", "FastIca"):
        import jax

        want = jax.random.key_data(jpd.utils.rng.key_from_seed(0))
        assert np.array_equal(jax.random.key_data(jm._key), want)


def test_jax_key_archive_gives_a_deterministic_port_stream():
    """A JAX archive's key seeds the port's generator from its words:
    two loads draw the same stream, the generator of those words."""
    jm = jpd.RandomizedPca(2, seed=RNG_SEED).fit(_X)
    data = jax_serialize.to_bytes(jm)
    a, b = _load(data), _load(data)
    assert torch.equal(a.fit(_X).components_, b.fit(_X).components_)
    import jax

    words = np.asarray(jax.random.key_data(jm._key), np.uint64).ravel()
    seed = int(words[0]) << 32 | int(words[1])
    want = port_rng.generator_from_seed(seed).get_state()
    assert torch.equal(_load(data)._gen.get_state(), want)


def test_load_places_tensors_on_the_default_device(monkeypatch):
    """``device=None`` resolves as a model built without ``device=``:
    the card, so with no card the load raises, as such a fit does."""
    blob = to_bytes(pt.Pca(2, device=CPU).fit(_X))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        from_bytes(blob)
    m = from_bytes(blob, device=CPU)
    assert m.components_.device == torch.device(CPU)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["Pca", "RandomizedPca", "FastIca"])
def test_card_archive_loads_on_cpu_and_back(cuda_device, name):
    """Saved on the card, loaded on the CPU and on the card: the card's
    load transforms bitwise, the CPU's within the float64 band; the
    card's next fit is the original's next fit."""
    make = {"Pca": lambda d: pt.Pca(3, device=d),
            "RandomizedPca": lambda d: pt.RandomizedPca(3, seed=5, device=d),
            "FastIca": lambda d: pt.FastIca(seed=5, device=d)}[name]
    m = make(cuda_device).fit(_X)
    blob = to_bytes(m)
    on_cpu = from_bytes(blob, device=CPU)
    back = from_bytes(to_bytes(on_cpu), device=cuda_device)
    assert torch.equal(back.transform(_X), m.transform(_X))
    assert _rel(on_cpu.transform(_X), m.transform(_X).cpu()) < 1e-10
    assert torch.equal(back.fit(_X).components_, m.fit(_X).components_)
