"""Sharded training and serving over spawned gloo ranks on the CPU.

Each mesh (2x1, 1x2, 2x2) runs in its own processes
(tests/torch_parallel_worker.py, one a rank, joined through a rendezvous
file under tmp_path so that no two runs race for a port), each process
waiting at most RANKS_TIMEOUT_S. The ranks train tiny `context` and `ar`
models for 3 steps at the presets' dropout (0.1) on the same global
batches as the one-rank port run here, serve them in float32 and int8,
save a checkpoint at 1x2 that 2x1 resumes, and run cli/distill.py --mesh
1x2 and cli/train.py --distributed --mesh 2x1.

Tolerances:
* sharded vs the one-rank port: each parameter's relative RMS gap at most
  SHARD_PARAM_RMS (measured 2e-9: float32 sums over shards in another
  order), loss, n_frames, grad_norm and loss_per_frame within
  SHARD_METRIC_RTOL;
* sharded (dropout off, JAX's draws injected) vs JAX's single-device
  steps: the loss within the train tests' 1e-5 relative
  (tests/test_torch_train.py); each parameter's change over the 3 steps
  within JAX_CHANGE_RMS relative RMS of JAX's change (measured 2.9e-3, at
  a norm scale: the gradients agree within the train tests' 3e-4 of their
  leaf's peak, and Adafactor's g / sqrt(v) turns a gradient's last bits
  into a visible share of an update of 1e-5);
* predict: float32 within PREDICT_F32_TOL (relative and absolute, the
  JAX package's own sharded-serving tolerance, tests/test_parallel.py;
  measured 5.1e-5 on values of 11.5 after 2 sampler steps); int8 within
  the int8 network tolerance of tests/test_torch_quantize.py (2.5% of the
  peak, 2% RMS).
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from music_spectrogram_diffusion_tpu import config as jax_config
from music_spectrogram_diffusion_tpu.infer import inference as jax_inference
from music_spectrogram_diffusion_tpu.ops import diffusion as jd
from music_spectrogram_diffusion_tpu.train import trainer as jax_trainer
from music_spectrogram_diffusion_tpu_torch import convert
from music_spectrogram_diffusion_tpu_torch.infer import inference
from tests import torch_parallel_worker as worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ("2x1", "1x2", "2x2")
STEPS, ROWS = 3, 4
RANKS_TIMEOUT_S = 240
SHARD_PARAM_RMS, SHARD_METRIC_RTOL = 1e-6, 1e-5
JAX_LOSS_RTOL, JAX_CHANGE_RMS = 1e-5, 1e-2
PREDICT_F32_TOL = 2e-4
INT8_MAX_REL, INT8_RMS_REL = 2.5e-2, 2e-2
WIDE = dict(emb_dim=128, num_heads=2, head_dim=64, mlp_dim=256)


def _context_batches(seed, count, rows=ROWS):
  r = np.random.RandomState(seed)
  out = {}
  for i in range(count):
    b = {"encoder_input_tokens": r.randint(1, 200, (rows, 32)).astype(
             np.int32),
         "encoder_continuous_inputs": (r.randn(rows, 16, 128) * 3 - 4
                                       ).astype(np.float32),
         "encoder_continuous_mask": np.ones((rows, 16), bool),
         "decoder_target_tokens": (r.randn(rows, 16, 128) * 3 - 4).astype(
             np.float32),
         "decoder_target_mask": np.ones((rows, 16), bool)}
    b["encoder_input_tokens"][1, 20:] = 0
    b["encoder_continuous_mask"][0, 9:] = False
    b["decoder_target_mask"][rows - 1, 12:] = False
    out.update({f"{i}/{k}": v for k, v in b.items()})
  return out


def _ar_batches(seed, count, rows=ROWS):
  r = np.random.RandomState(seed)
  out = {}
  for i in range(count):
    targets = r.randn(rows, 8, 128).astype(np.float32)
    inputs = np.roll(targets, 1, axis=1)
    inputs[:, 0] = 0
    b = {"encoder_input_tokens": r.randint(1, 100, (rows, 16)).astype(
             np.int32),
         "decoder_input_tokens": inputs, "decoder_target_tokens": targets,
         "decoder_target_mask": np.ones((rows, 8), bool)}
    b["decoder_target_mask"][1, 5:] = False
    out.update({f"{i}/{k}": v for k, v in b.items()})
  return out


def _unflatten(flat):
  """{'<i>/<key>': array} -> [batch i]."""
  return [{k.split("/", 1)[1]: v for k, v in flat.items()
           if k.startswith(f"{i}/")}
          for i in sorted({int(k.split("/")[0]) for k in flat})]


def _jax_steps(batches):
  """JAX's single-device steps on `batches` with dropout off: the loss_fn
  of `dropout_rng=None` (its draws from PRNGKey(0), the same each step),
  then the trainer's optimizer. Returns (initial params as a port
  state_dict, the draws, the losses, the final params)."""
  jexp = dataclasses.replace(jax_config.preset("context_tiny"),
                             vocab_size=256, dropout_rate=0.0)
  jm = jax_inference.build_model(jexp)
  first = {k: jnp.asarray(v) for k, v in batches[0].items()}
  params = jax.jit(lambda key: jm.init_variables(
      key, {k: v.shape for k, v in first.items()},
      {k: v.dtype for k, v in first.items()}))(
          jax.random.PRNGKey(0))["params"]
  targets = jm.audio_codec.scale_features(
      first["decoder_target_tokens"], output_range=(-1.0, 1.0), clip=True)
  _, eps, time, include = jd.training_input(
      jax.random.split(jax.random.PRNGKey(0))[1], targets,
      jm.diffusion_config)
  tx = jax_trainer.make_optimizer(jexp.train)
  opt_state = tx.init(params)

  @jax.jit
  def step(params, opt_state, batch):
    (loss, _), grads = jax.value_and_grad(
        lambda p: jm.loss_fn(p, batch, None), has_aux=True)(params)
    updates, opt_state = tx.update(grads, opt_state, params)
    return jax.tree.map(lambda p, u: p + u, params, updates), opt_state, loss

  port_module = inference.network(worker.experiment_of(_jax_job(None)))
  init = {k: v.numpy() for k, v in convert.flax_to_state_dict(
      jax.tree.map(np.asarray, params), port_module).items()}
  losses = []
  for b in batches:
    params, opt_state, loss = step(params, opt_state,
                                   {k: jnp.asarray(v) for k, v in b.items()})
    losses.append(float(loss))
  final = {k: v.numpy() for k, v in convert.flax_to_state_dict(
      jax.tree.map(np.asarray, params), port_module).items()}
  draws = dict(eps=np.asarray(eps), time=np.asarray(time),
               include=np.asarray(include))
  return init, draws, np.asarray(losses), final


def _jax_job(data):
  job = dict(kind="train", name="context_jax", preset="context_tiny",
             overrides=dict(vocab_size=256, dropout_rate=0.0), steps=STEPS,
             seed=1)
  if data is not None:
    job.update(batches=data["context"], init=data["jax_init"],
               draws=data["jax_draws"])
  return job


def _jobs(data, mesh, model_dirs):
  context = dict(kind="train", name="context", preset="context_tiny",
                 batches=data["context"], steps=STEPS, seed=1)
  jobs = [context,
          dict(kind="train", name="ar", preset="ar_tiny",
               batches=data["ar"], steps=STEPS, seed=2),
          _jax_job(data),
          dict(kind="predict", name="predict_float32", preset="context_tiny",
               sampler_steps=2, batches=data["predict"],
               compute_dtype="float32"),
          dict(kind="predict", name="predict_int8", preset="context_tiny",
               sampler_steps=2, widths=WIDE, batches=data["predict"],
               compute_dtype="int8", min_dim=128),
          dict(kind="round_trip", name="round_trip")]
  if mesh == "1x2":
    # Two steps through TrainLoop, saved; 2x1 resumes for the third.
    jobs.append(dict(context, name="saved", steps=2,
                     model_dir=model_dirs["loop"]))
    jobs.append(dict(kind="cli", name="distill", cli="distill", argv=[
        "--teacher", model_dirs["loop"], "--model_dir", model_dirs["distill"],
        "--rounds", "1", "--steps_per_round", "1", "--batch", "2",
        "--synthetic", "--synthetic_examples", "2", "--data_threads", "1",
        "--log_period", "1", "--device", "cpu", "--mesh", "1x2"]))
  if mesh == "2x1":
    jobs.append(dict(context, name="resumed", model_dir=model_dirs["loop"]))
    jobs.append(dict(kind="cli", name="train_cli", cli="train", argv=[
        "--preset", "context_tiny", "--model_dir", model_dirs["cli"],
        "--steps", "2", "--batch", "2", "--synthetic",
        "--synthetic_examples", "2", "--data_threads", "1", "--log_period",
        "1", "--device", "cpu", "--distributed", "--mesh", "2x1"]))
  return jobs


def _start_ranks(workdir, mesh, jobs):
  os.makedirs(workdir, exist_ok=True)
  jobs_path = os.path.join(workdir, "jobs.json")
  with open(jobs_path, "w") as f:
    json.dump(jobs, f)
  world = int(np.prod(worker.mesh_lib.parse_mesh(mesh)))
  rendezvous = os.path.join(workdir, "rendezvous")
  env = dict(os.environ, OMP_NUM_THREADS="1")
  return [subprocess.Popen(
      [sys.executable, "-m", "tests.torch_parallel_worker", str(rank),
       str(world), rendezvous, mesh, jobs_path, workdir], cwd=ROOT, env=env,
      stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
          for rank in range(world)]


def _wait(procs, mesh):
  logs = []
  try:
    for p in procs:
      out, _ = p.communicate(timeout=RANKS_TIMEOUT_S)
      logs.append(out.decode(errors="replace"))
  except subprocess.TimeoutExpired:
    for p in procs:
      p.kill()
      p.wait()
    pytest.fail(f"the {mesh} ranks took more than {RANKS_TIMEOUT_S} s")
  for p, log in zip(procs, logs):
    assert p.returncode == 0, f"{mesh} rank failed:\n{log[-4000:]}"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
  root = tmp_path_factory.mktemp("parallel_data")
  paths = {}
  for name, flat in (("context", _context_batches(0, STEPS)),
                     ("ar", _ar_batches(1, STEPS)),
                     ("predict", _context_batches(2, 1, rows=2))):
    paths[name] = str(root / f"{name}.npz")
    np.savez(paths[name], **flat)
  init, draws, losses, final = _jax_steps(_unflatten(
      _context_batches(0, STEPS)))
  paths["jax_init"], paths["jax_draws"] = (str(root / "init.npz"),
                                           str(root / "draws.npz"))
  np.savez(paths["jax_init"], **init)
  np.savez(paths["jax_draws"], **draws)
  return dict(paths, jax_losses=losses, jax_init_params=init,
              jax_final=final)


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
  """{mesh: its output directory}: 1x2 and 2x2 at once, then 2x1 (which
  resumes 1x2's checkpoint)."""
  root = tmp_path_factory.mktemp("parallel_runs")
  dirs = {"loop": str(root / "loop"), "distill": str(root / "distill"),
          "cli": str(root / "cli")}
  out = {mesh: str(root / mesh) for mesh in MESHES}
  first = {mesh: _start_ranks(out[mesh], mesh, _jobs(data, mesh, dirs))
           for mesh in ("1x2", "2x2")}
  for mesh, procs in first.items():
    _wait(procs, mesh)
  _wait(_start_ranks(out["2x1"], "2x1", _jobs(data, "2x1", dirs)), "2x1")
  return dict(out, **dirs)


def _result(runs, mesh, name):
  with np.load(os.path.join(runs[mesh], name + ".npz")) as f:
    return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def one_rank(data):
  """The one-rank port runs the sharded ones are held to."""
  out = {}
  for job in _jobs(data, "-", {}):
    if job["kind"] == "train":
      out[job["name"]] = worker.train(job, None)
    elif job["kind"] == "predict":
      out[job["name"]] = worker.predict(job, None)
  return out


def _params_close(got, want, limit):
  for name, w in want.items():
    g = got[f"params/{name}"]
    assert g.shape == w.shape, name
    gap = np.sqrt(np.mean((g - w) ** 2) / max(np.mean(w ** 2), 1e-30))
    assert gap <= limit, (name, gap)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("family", ["context", "ar"])
def test_sharded_training_equals_one_rank(runs, one_rank, mesh, family):
  """3 steps with dropout: the updated parameters, loss, n_frames and
  grad_norm of the sharded run are the one-rank run's."""
  got = _result(runs, mesh, family)
  rows, params, step = one_rank[family]
  assert int(got["step"]) == step == STEPS
  np.testing.assert_allclose(got["metrics"], rows, rtol=SHARD_METRIC_RTOL)
  assert np.all(rows[:, 2] > 0)
  _params_close(got, params, SHARD_PARAM_RMS)


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_training_equals_jax(runs, data, mesh):
  got = _result(runs, mesh, "context_jax")
  np.testing.assert_allclose(got["metrics"][:, 0], data["jax_losses"],
                             rtol=JAX_LOSS_RTOL)
  worst = {}
  for name, want in data["jax_final"].items():
    start = data["jax_init_params"][name]
    change = want - start
    gap = got[f"params/{name}"] - want
    worst[name] = np.sqrt(np.mean(gap ** 2) / max(np.mean(change ** 2),
                                                  1e-30))
  assert max(worst.values()) <= JAX_CHANGE_RMS, max(worst.items(),
                                                     key=lambda kv: kv[1])


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_sharded_predict_equals_unsharded(runs, one_rank, mesh, dtype):
  got = _result(runs, mesh, f"predict_{dtype}")["mel"]
  want = one_rank[f"predict_{dtype}"]
  assert got.shape == want.shape == (2, 16, 128)
  if dtype == "float32":
    np.testing.assert_allclose(got, want, rtol=PREDICT_F32_TOL,
                               atol=PREDICT_F32_TOL)
  else:
    peak = np.abs(want).max()
    assert np.abs(got - want).max() <= INT8_MAX_REL * peak
    assert np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)
                   ) <= INT8_RMS_REL


def test_checkpoint_saved_at_1x2_resumes_at_2x1(runs, one_rank):
  """Two steps at 1x2 through TrainLoop, saved (full tensors); the third
  at 2x1 from that checkpoint equals three straight one-rank steps."""
  from music_spectrogram_diffusion_tpu_torch.train import checkpoints
  saved = checkpoints.restore_checkpoint(os.path.join(runs["loop"],
                                                      "step_2"))
  _, params, _ = one_rank["context"]
  assert {k: tuple(v.shape) for k, v in saved["params"].items()} == {
      k: v.shape for k, v in params.items()}
  resumed = _result(runs, "2x1", "resumed")
  assert int(resumed["step"]) == STEPS
  _params_close(resumed, params, SHARD_PARAM_RMS)
  # Only rank 0 wrote: one metrics line a step.
  with open(os.path.join(runs["loop"], "metrics.jsonl")) as f:
    assert [json.loads(l)["step"] for l in f] == [1, 2, 3]


def test_distill_cli_runs_a_step_at_1x2(runs):
  assert bool(_result(runs, "1x2", "distill")["ok"])
  round_dir = os.path.join(runs["distill"], "round_0")
  served = inference.load_checkpoint(round_dir, device="cpu")
  assert served.step == 1
  with open(os.path.join(round_dir, "metrics.jsonl")) as f:
    lines = [json.loads(l) for l in f]
  assert [m["step"] for m in lines] == [1] and np.isfinite(lines[0]["loss"])


def test_train_cli_distributed_at_2x1(runs):
  assert bool(_result(runs, "2x1", "train_cli")["ok"])
  with open(os.path.join(runs["cli"], "metrics.jsonl")) as f:
    lines = [json.loads(l) for l in f]
  assert [m["step"] for m in lines] == [1, 2]
  # The global batch of 2: both data groups' rows.
  assert all(m["n_seqs"] == 2 for m in lines)


@pytest.mark.parametrize("mesh", MESHES)
def test_shard_then_gather_round_trips_bit_for_bit(runs, mesh):
  """parallel.mesh.shard_pytree then gather_pytree, on each mesh: every
  float (-0.0, NaN and inf among them), bf16 and int8 tensor comes back
  with its bits."""
  import torch
  got = _result(runs, mesh, "round_trip")
  for name, want in worker.round_trip_tensors().items():
    bits = (want.view(torch.int16) if want.dtype == torch.bfloat16
            else want.view(torch.int32) if want.dtype == torch.float32
            else want).numpy()
    back = got[name]
    if back.dtype == np.float32:
      back = back.view(np.int32)
    np.testing.assert_array_equal(back, bits, err_msg=name)
