"""The port's VGGish and TRILL against the JAX package's, on random
weights written in the converted `.npz` layout (the repository holds no
trained ones): the log-mel patch frontends bit for bit, the embeddings
within 1e-4 of JAX's relative to the largest |value| (float32 convs in
two frameworks), and the registration rules.
"""

import numpy as np
import pytest

from music_spectrogram_diffusion_tpu.infer import (trill as jax_trill,
                                                   vggish as jax_vggish)
from music_spectrogram_diffusion_tpu_torch.infer import (postprocessors,
                                                         trill, vggish)

PAIRS = {"vggish": (jax_vggish, vggish, jax_vggish.VGGishEmbedder,
                    vggish.VGGishEmbedder, 128),
         "trill": (jax_trill, trill, jax_trill.TRILLEmbedder,
                   trill.TRILLEmbedder, 512)}


@pytest.fixture
def restore_embedders():
  saved = dict(postprocessors.EMBEDDING_MODELS)
  yield
  postprocessors.EMBEDDING_MODELS.clear()
  postprocessors.EMBEDDING_MODELS.update(saved)


@pytest.mark.parametrize("name", sorted(PAIRS))
@pytest.mark.parametrize("n_samples", [15000, 40000])
def test_patches_equal_jax(name, n_samples):
  jax_lib, port_lib = PAIRS[name][:2]
  audio = np.random.RandomState(n_samples).randn(n_samples).astype(
      np.float32) * 0.1
  want, got = jax_lib.log_mel_patches(audio), port_lib.log_mel_patches(audio)
  assert got.dtype == want.dtype and got.shape == want.shape
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(vggish.log_mel_frames(audio),
                                jax_vggish.log_mel_frames(audio))


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_embeddings_match_jax(name, tmp_path):
  jax_lib, port_lib, jax_cls, port_cls, dim = PAIRS[name]
  path = str(tmp_path / f"{name}.npz")
  np.savez(path, **port_lib.random_weights(1))
  # The converted layout is the JAX module's own tree.
  import jax
  init = jax_lib.VGGish() if name == "vggish" else jax_lib.ResNetish50()
  tree = jax.eval_shape(init.init, jax.random.PRNGKey(0),
                        np.zeros((1, 96, 64), np.float32))
  loaded = jax_lib.load_params(path)
  assert (jax.tree_util.tree_map(lambda x: x.shape, tree)
          == jax.tree_util.tree_map(np.shape, loaded))
  audio = np.random.RandomState(2).randn(36000).astype(np.float32) * 0.1
  want = jax_cls(path)(audio)
  got = port_cls(path, device="cpu")(audio)
  assert got.shape == want.shape == (len(port_lib.log_mel_patches(audio)),
                                     dim)
  scale = np.abs(want).max()
  assert scale > 0
  np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
  empty = port_cls(path, device="cpu")(np.zeros(100, np.float32))
  assert empty.shape == (0, dim)


def test_same_padding_is_flax_same():
  """Flax's SAME with stride 2 on an even size pads the extra row at the
  end; the max-pool pads with -inf."""
  import torch
  x = torch.arange(16.0).reshape(1, 1, 4, 4)
  padded = trill._same_pad(x, (3, 3), (2, 2), float("-inf"))
  assert padded.shape == (1, 1, 5, 5)
  assert torch.isinf(padded[0, 0, -1]).all()
  assert torch.equal(padded[0, 0, :4, :4], x[0, 0])
  assert trill._same_pad(x, (7, 7), (1, 1)).shape == (1, 1, 10, 10)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_register(name, tmp_path, monkeypatch, restore_embedders):
  port_lib = PAIRS[name][1]
  monkeypatch.delenv(f"MSD_{name.upper()}_WEIGHTS", raising=False)
  assert not port_lib.register(None, device="cpu")
  assert not port_lib.register(str(tmp_path / "missing.npz"), device="cpu")
  assert name not in postprocessors.EMBEDDING_MODELS
  path = str(tmp_path / f"{name}.npz")
  np.savez(path, **port_lib.random_weights(0))
  monkeypatch.setenv(f"MSD_{name.upper()}_WEIGHTS", path)
  assert port_lib.register(None, device="cpu")
  embs = postprocessors.get_embeddings(np.random.RandomState(3).randn(
      32000).astype(np.float32) * 0.1)
  assert embs[name].shape == ((2, 128) if name == "vggish" else (7, 512))
  assert np.all(np.isfinite(embs[name]))
