"""The port's MT3 (infer/mt3.py) against the JAX package's at a tiny
geometry (2+2 layers, emb 64, 2 heads x 32, max_tokens 16, beam 2), on the
JAX module's random weights; JAX's outputs are computed once per module.

Tolerances: the spectrogram frontend bit for bit (numpy in both);
teacher-forced logits within 1e-4 of JAX's relative to the largest
|logit|; the encoder output within 1e-4 relative on the valid frames only
(JAX masks queries and keys, the port's kernel keys only, so the padded
frames' rows differ, and the decoder's cross-attention masks them out);
greedy and beam tokens equal JAX's, and where one differs the test shows
JAX's margin at the first differing step below the logit tolerance
(greedy: the top-2 logits; beam: the two competing candidates, whose
scores extend one shared prefix and so differ by their two logits); beam
tokens equal JAX's exactly where a hypothesis ends (EOS made a close
second), so that the finished pool and the brevity penalty decide; the
transcriber's NoteSequence equal to JAX's; the transcriber's fixed decode
batches give the tokens of one decode of every segment.
"""

import dataclasses
import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from music_spectrogram_diffusion_tpu.infer import mt3 as jax_mt3
from music_spectrogram_diffusion_tpu.midi import vocabularies as jax_voc
from music_spectrogram_diffusion_tpu_torch import convert
from music_spectrogram_diffusion_tpu_torch.infer import mt3, transcription

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMETRY = dict(emb_dim=64, num_heads=2, num_encoder_layers=2,
                num_decoder_layers=2, head_dim=32, mlp_dim=128)
MAX_TOKENS = 16
BEAM = 2
LOGIT_TOLERANCE = 1e-4  # relative to the largest |logit|
EOS_COLUMN_SCALE = 0.98


def _vocab_size():
  vc = jax_voc.VocabularyConfig(num_velocity_bins=1)
  return jax_voc.num_embeddings(jax_voc.vocabulary_from_codec(
      jax_voc.build_codec(vc)))


def _inputs():
  rng = np.random.RandomState(0)
  spec = (rng.randn(2, 256, mt3.NUM_MEL_BINS) * 2.0).astype(np.float32)
  mask = np.ones((2, 256), bool)
  mask[1, 190:] = False
  return spec, mask


@pytest.fixture(scope="module")
def ref():
  """JAX's module, params and outputs, computed once."""
  vocab = _vocab_size()
  module = jax_mt3.MT3Transformer(config=jax_mt3.MT3Config(
      vocab_size=vocab, **GEOMETRY))
  spec, mask = _inputs()
  rng = np.random.RandomState(1)
  targets = rng.randint(2, vocab, (2, 12)).astype(np.int32)
  targets[1, 9:] = 0
  inputs = np.pad(targets, ((0, 0), (1, 0)))[:, :-1]
  params = jax.tree_util.tree_map(np.asarray, module.init(
      jax.random.PRNGKey(0), spec[:1], mask[:1], targets[:1],
      targets[:1])["params"])
  out = dict(module=module, params=params, spec=spec, mask=mask,
             targets=targets, inputs=inputs, vocab=vocab)
  out["logits"] = np.asarray(module.apply({"params": params}, spec, mask,
                                          inputs, targets))
  out["encoded"] = np.asarray(module.apply({"params": params}, spec, mask,
                                           method=module.encode))
  out["greedy"] = np.asarray(jax.jit(functools.partial(
      jax_mt3.greedy_decode, module, max_tokens=MAX_TOKENS))(
          params, spec, mask))
  beam = jax.jit(functools.partial(
      jax_mt3.beam_decode, module, max_tokens=MAX_TOKENS, beam_size=BEAM))
  out["beam"] = np.asarray(beam(params, spec, mask))
  # The same weights with EOS made a close second to the token greedy
  # picks most (its logits column 0.98 of that token's): a hypothesis
  # ends inside MAX_TOKENS, so the finished pool, its merge and the
  # brevity penalty decide the result.
  values, counts = np.unique(out["greedy"], return_counts=True)
  eos_params = jax.tree_util.tree_map(np.copy, params)
  kernel = eos_params["decoder"]["logits_dense"]["kernel"]
  kernel[:, 1] = EOS_COLUMN_SCALE * kernel[:, values[np.argmax(counts)]]
  out["eos_params"] = eos_params
  out["beam_eos"] = np.asarray(beam(eos_params, spec, mask))
  return out


def _port_module(ref, params_key="params"):
  config = mt3.MT3Config(vocab_size=ref["vocab"], **GEOMETRY)
  state = convert.flax_to_state_dict(ref[params_key],
                                     mt3.MT3Transformer(config))
  return mt3.build_module(config, state_dict=state, device="cpu")


def _jax_stepwise_logits(ref, tokens):
  """JAX's logits at every step of the decode that produced `tokens`
  (teacher-forced on them, every position valid)."""
  inputs = np.pad(tokens, ((0, 0), (1, 0)))[:, :-1].astype(np.int32)
  return np.asarray(ref["module"].apply(
      {"params": ref["params"]}, ref["spec"], ref["mask"], inputs,
      np.ones_like(inputs)))


def test_spectrogram_equals_jax():
  audio = np.random.RandomState(2).randn(40000).astype(np.float32) * 0.1
  got, want = mt3.spectrogram(audio), jax_mt3.spectrogram(audio)
  assert got.shape == (313, 512) and got.dtype == want.dtype
  np.testing.assert_array_equal(got, want)


def test_teacher_forced_logits_match_jax(ref):
  module = _port_module(ref)
  with torch.no_grad():
    logits = module(torch.as_tensor(ref["spec"]), torch.as_tensor(ref["mask"]),
                    torch.as_tensor(ref["inputs"]),
                    torch.as_tensor(ref["targets"])).numpy()
    encoded = module.encode(torch.as_tensor(ref["spec"]),
                            torch.as_tensor(ref["mask"])).numpy()
  scale = np.abs(ref["logits"]).max()
  np.testing.assert_allclose(logits, ref["logits"], rtol=0,
                             atol=LOGIT_TOLERANCE * scale)
  valid = ref["mask"]
  np.testing.assert_allclose(encoded[valid], ref["encoded"][valid], rtol=0,
                             atol=1e-4 * np.abs(ref["encoded"]).max())


def _first_differences(got, want):
  """(row, step) of each row's first token where `got` differs."""
  out = []
  for row in range(len(want)):
    diff = np.nonzero(got[row] != want[row])[0]
    if len(diff):
      out.append((row, int(diff[0])))
  return out


def test_greedy_tokens_equal_jax(ref):
  got = mt3.greedy_decode(_port_module(ref), torch.as_tensor(ref["spec"]),
                          torch.as_tensor(ref["mask"]), MAX_TOKENS).numpy()
  want = ref["greedy"]
  assert got.shape == want.shape == (2, MAX_TOKENS)
  if not np.array_equal(got, want):
    logits = _jax_stepwise_logits(ref, want)
    tol = LOGIT_TOLERANCE * np.abs(logits).max()
    for row, step in _first_differences(got, want):
      top2 = np.sort(logits[row, step])[-2:]
      assert top2[1] - top2[0] < tol, (row, step, top2)


def test_beam_tokens_equal_jax(ref):
  module = _port_module(ref)
  got = mt3.beam_decode(module, torch.as_tensor(ref["spec"]),
                        torch.as_tensor(ref["mask"]), MAX_TOKENS,
                        beam_size=BEAM).numpy()
  want = ref["beam"]
  assert got.shape == want.shape == (2, MAX_TOKENS)
  for row in got:  # zeroed after the first EOS
    if (row == 1).any():
      assert not row[int(np.argmax(row == 1)) + 1:].any()
  if not np.array_equal(got, want):
    # At a row's first differing step both tokens extend the same prefix,
    # so JAX's scores of the two candidates differ by exactly the
    # difference of their logits there (log_softmax shares the
    # normalizer): that margin must be below the logit tolerance.
    logits = _jax_stepwise_logits(ref, want)
    tol = LOGIT_TOLERANCE * np.abs(logits).max()
    for row, step in _first_differences(got, want):
      pair = logits[row, step, [want[row, step], got[row, step]]]
      assert abs(pair[0] - pair[1]) < tol, (row, step, pair)


def test_beam_finished_pool_equals_jax(ref):
  """Beam search where a hypothesis ends (EOS a close second, see `ref`):
  the tokens equal JAX's exactly, EOS included."""
  assert (ref["beam_eos"] == 1).any()
  got = mt3.beam_decode(_port_module(ref, "eos_params"),
                        torch.as_tensor(ref["spec"]),
                        torch.as_tensor(ref["mask"]), MAX_TOKENS,
                        beam_size=BEAM).numpy()
  np.testing.assert_array_equal(got, ref["beam_eos"])


def test_stable_top_k_puts_lower_index_first():
  x = torch.tensor([[1.0, 3.0, 3.0, -1e7, 3.0, -1e7]])
  values, idx = mt3.stable_top_k(x, 4)
  assert idx.tolist() == [[1, 2, 4, 0]]
  assert values.tolist() == [[3.0, 3.0, 3.0, 1.0]]
  assert jax.lax.top_k(jnp.asarray(x.numpy()), 4)[1].tolist() == [[1, 2, 4, 0]]


def _jax_transcriber(ref, decode_mode):
  t = jax_mt3.MT3Transcriber(
      ref["params"], max_tokens=MAX_TOKENS, decode_mode=decode_mode,
      beam_size=BEAM, config=jax_mt3.MT3Config(vocab_size=ref["vocab"],
                                               **GEOMETRY))
  return t


def _clip():
  from music_spectrogram_diffusion_tpu_torch.data import synthetic
  rng = np.random.RandomState(4)
  ns = synthetic.random_note_sequence(rng, duration=5.0)
  return synthetic.render_note_sequence(ns, 16000, duration=5.0)


def _notes(ns):
  return [(n.pitch, n.velocity, round(n.start_time, 6), round(n.end_time, 6),
           n.program, n.is_drum) for n in ns.notes]


@pytest.mark.parametrize("decode_mode", ["greedy", "beam"])
def test_transcriber_equals_jax(ref, decode_mode):
  audio = _clip()
  want = _jax_transcriber(ref, decode_mode)(audio)
  port = mt3.MT3Transcriber(
      ref["params"], max_tokens=MAX_TOKENS, decode_mode=decode_mode,
      beam_size=BEAM, config=mt3.MT3Config(vocab_size=ref["vocab"],
                                           **GEOMETRY), device="cpu")
  got = port(audio)
  assert _notes(got) == _notes(want)
  assert got.total_time == want.total_time


def test_transcriber_decodes_in_fixed_batches(ref):
  """More segments than DECODE_BATCH: two batches, the second padded with
  frameless segments; each segment's tokens are those of one greedy decode
  of all of them."""
  n = mt3.DECODE_BATCH + 3
  rng = np.random.RandomState(6)
  segs = (rng.randn(n, 256, mt3.NUM_MEL_BINS) * 2.0).astype(np.float32)
  mask = np.ones((n, 256), bool)
  mask[-1, 100:] = False
  port = mt3.MT3Transcriber(
      ref["params"], max_tokens=MAX_TOKENS, decode_mode="greedy",
      config=mt3.MT3Config(vocab_size=ref["vocab"], **GEOMETRY),
      device="cpu")
  got = port.decode(segs, mask)
  want = mt3.greedy_decode(port.module, torch.as_tensor(segs),
                           torch.as_tensor(mask), MAX_TOKENS).numpy()
  assert got.shape == (n, MAX_TOKENS)
  np.testing.assert_array_equal(got, want)


def test_transcriber_decodes_song_tokens_as_jax(ref):
  """The token -> NoteSequence stage on a real song's event tokens (the
  training segments of a 5 s synthetic song, three segments with tie
  sections), in place of the random network's: JAX's notes, not none."""
  import argparse
  from music_spectrogram_diffusion_tpu_torch.cli import train_transcriber
  from music_spectrogram_diffusion_tpu_torch.midi import vocabularies
  vc = vocabularies.VocabularyConfig(num_velocity_bins=1)
  codec = vocabularies.build_codec(vc)
  args = argparse.Namespace(seed=5, synthetic_examples=1, song_seconds=5.0,
                            max_tokens=1024, program_granularity="flat")
  _, tokens, _ = train_transcriber.generate_segments(
      args, codec, vocabularies.vocabulary_from_codec(codec))
  assert len(tokens) == 3
  audio = np.zeros(5 * 16000, np.float32)
  want_tr = _jax_transcriber(ref, "greedy")
  want_tr._decode = lambda params, segs, mask: tokens
  port = mt3.MT3Transcriber(
      ref["params"], max_tokens=MAX_TOKENS, decode_mode="greedy",
      config=mt3.MT3Config(vocab_size=ref["vocab"], **GEOMETRY),
      device="cpu")
  port.decode = lambda segs, mask: tokens
  want, got = want_tr(audio), port(audio)
  assert len(want.notes) > 5
  assert _notes(got) == _notes(want)


def _t5x_tree(params):
  """The JAX module's tree in the published t5x/mt3 names (what
  `remap_mt3_params` undoes)."""
  flat = convert.flatten(params)
  out = {}
  for k, v in flat.items():
    k = k.replace("decoder/token_embedder/", "token_embedder/")
    k = k.replace("input_proj", "continuous_inputs_projection")
    for norm in ("pre_self_attention", "pre_cross_attention",
                 "pre_attention", "pre_mlp"):
      k = k.replace(f"{norm}_norm", f"{norm}_layer_norm")
    out[k] = v
  return convert.unflatten(out)


def test_remap_gives_the_module_tree(ref):
  remapped = mt3.remap_mt3_params(_t5x_tree(ref["params"]))
  got = {k: np.shape(v) for k, v in convert.flatten(remapped).items()}
  want = {k: np.shape(v) for k, v in convert.flatten(ref["params"]).items()}
  assert got == want
  want_jax = {k: np.shape(v) for k, v in convert.flatten(
      jax_mt3.remap_mt3_params(_t5x_tree(ref["params"]))).items()}
  assert got == want_jax
  config = mt3.MT3Config(vocab_size=ref["vocab"], **GEOMETRY)
  state = convert.flax_to_state_dict(remapped, mt3.MT3Transformer(config))
  assert len(state) == len(got)


def test_load_mt3_checkpoint_and_register(ref, tmp_path, monkeypatch):
  """A T5X export (the tool's `.npz`: params/<path>, config_json, step)
  loads, remaps and registers as the transcriber (at the tiny geometry:
  `register` builds MT3's default one, as JAX's does)."""
  config = mt3.MT3Config(vocab_size=ref["vocab"], **GEOMETRY)
  cls = mt3.MT3Transcriber
  monkeypatch.setattr(mt3, "MT3Transcriber", functools.partial(
      cls, config=config, max_tokens=MAX_TOKENS))
  path = str(tmp_path / "mt3.npz")
  arrays = {f"params/{k}": v for k, v in convert.flatten(
      _t5x_tree(ref["params"])).items()}
  np.savez(path, config_json=np.asarray(""), step=np.asarray(7), **arrays)
  tree = mt3.load_mt3_checkpoint(path)
  for k, v in convert.flatten(ref["params"]).items():
    np.testing.assert_array_equal(convert.flatten(tree)[k], v)
  saved = transcription.get_transcriber()
  try:
    assert not mt3.register(None, device="cpu")
    assert mt3.register(params=tree, device="cpu") is True
    assert isinstance(transcription.get_transcriber(), cls)
  finally:
    transcription.register_transcriber(saved)


def _train(model_dir, steps):
  from music_spectrogram_diffusion_tpu_torch.cli import train_transcriber
  return train_transcriber.main([
      "--model_dir", model_dir, "--synthetic_examples", "3",
      "--song_seconds", "3.0", "--steps", str(steps), "--batch", "2",
      "--log_period", "1", "--checkpoint_period", "1", "--emb_dim", "64",
      "--num_layers", "1", "--num_heads", "2", "--mlp_dim", "64",
      "--max_tokens", "128", "--device", "cpu"])


def test_load_trained_transcriber_reads_the_port_cli(tmp_path):
  model_dir = str(tmp_path / "tr")
  _train(model_dir, 1)
  tr = mt3.load_trained_transcriber(model_dir, max_tokens=8, device="cpu")
  assert tr.module.config.emb_dim == 64
  assert tr.module.config.num_encoder_layers == 1
  assert tr.decode_mode == "greedy" and tr.max_tokens == 8
  ns = tr(_clip()[:16000])
  for n in ns.notes:
    assert 0 <= n.pitch < 128 and n.end_time >= n.start_time >= 0.0
  assert mt3.load_trained_transcriber(
      os.path.join(model_dir, "step_1"), device="cpu").max_tokens == 128
  with open(os.path.join(model_dir, "step_1", "config.json"), "w") as f:
    json.dump({"kind": "context_diffusion"}, f)
  with pytest.raises(ValueError, match="not a transcriber"):
    mt3.load_trained_transcriber(model_dir, device="cpu")


def test_export_round_trip_of_a_jax_transcriber(ref, tmp_path):
  """tools/export_jax_checkpoint.py on a JAX transcriber directory; the
  port's load_trained_transcriber reads the `.npz` and transcribes as
  JAX's load_trained_transcriber does."""
  import optax
  from music_spectrogram_diffusion_tpu.train import checkpoints
  sys.path.insert(0, os.path.join(ROOT, "tools"))
  try:
    import export_jax_checkpoint
  finally:
    sys.path.pop(0)
  arch = dict(GEOMETRY)
  sidecar = json.dumps({
      "kind": "mt3_transcriber", "arch": arch,
      "vocab": dataclasses.asdict(jax_voc.VocabularyConfig(
          num_velocity_bins=1)),
      "max_tokens": MAX_TOKENS})
  model_dir = str(tmp_path / "jax_tr")
  checkpoints.save_checkpoint(model_dir, 3, ref["params"],
                              opt_state=optax.adamw(1e-3).init(
                                  ref["params"]),
                              config_json=sidecar)
  out = str(tmp_path / "tr.npz")
  arrays = export_jax_checkpoint.export(model_dir, out)
  assert int(arrays["step"]) == 3
  port = mt3.load_trained_transcriber(out, device="cpu")
  want = jax_mt3.load_trained_transcriber(model_dir)
  assert port.max_tokens == want.max_tokens == MAX_TOKENS
  audio = _clip()
  assert _notes(port(audio)) == _notes(want(audio))
  with open(os.path.join(model_dir, "step_3", "config.json"), "w") as f:
    f.write(json.dumps({"kind": "vocoder"}))
  export_jax_checkpoint.export(model_dir, out)
  with pytest.raises(ValueError, match="not a transcriber"):
    mt3.load_trained_transcriber(out, device="cpu")
