"""One rank of the port's sharded runs on the CPU (tests/test_torch_parallel.py).

  python -m tests.torch_parallel_worker RANK WORLD RENDEZVOUS MESH JOBS OUT

Joins a gloo process group through the file RENDEZVOUS, builds the
DATAxMODEL mesh MESH over WORLD ranks and runs the jobs of the JSON file
JOBS; rank 0 writes each job's results (the full, gathered tensors) into
OUT/<job name>.npz. Imports no JAX: the test process holds the results
against the one-rank port run and against JAX.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch

from music_spectrogram_diffusion_tpu_torch import config
from music_spectrogram_diffusion_tpu_torch.infer import inference
from music_spectrogram_diffusion_tpu_torch.ops import quantize
from music_spectrogram_diffusion_tpu_torch.parallel import mesh as mesh_lib
from music_spectrogram_diffusion_tpu_torch.parallel import multihost
from music_spectrogram_diffusion_tpu_torch.train import loop, trainer


def experiment_of(job):
  """The job's experiment: a preset with the job's overrides (fields,
  train config, sampler steps, network widths)."""
  experiment = config.preset(job["preset"])
  train = dict(job.get("train", {}))
  experiment = dataclasses.replace(
      experiment, train=dataclasses.replace(experiment.train, **train),
      **job.get("overrides", {}))
  if "sampler_steps" in job:
    experiment = inference.with_sampler(experiment,
                                        sampler_steps=job["sampler_steps"])
  if "widths" in job:
    experiment = widened(experiment, job["widths"])
  return experiment


def widened(experiment, widths):
  """The experiment with its network's widths replaced."""
  class Widened(config.ExperimentConfig):
    def network(self):
      return dataclasses.replace(super().network(), **widths)
  return Widened(**{f.name: getattr(experiment, f.name)
                    for f in dataclasses.fields(experiment)})


def load_npz(path):
  with np.load(path) as f:
    return {k: f[k] for k in f.files}


def batches_of(job):
  """The job's global batches: a list of dicts, batch i's key k stored as
  `<i>/<k>`."""
  flat = load_npz(job["batches"])
  out = {}
  for key, value in flat.items():
    i, name = key.split("/", 1)
    out.setdefault(int(i), {})[name] = value
  return [out[i] for i in sorted(out)]


def train(job, mesh):
  """`steps` train steps on the job's global batches (each rank its
  rows; mesh None: one rank), from the job's initial state or seed 0;
  with `draws`, the diffusion draws injected (global arrays, the same each
  step); with `model_dir`, through TrainLoop (resuming from what is
  there). Returns (the steps' loss, n_frames, grad_norm and
  loss_per_frame, the full parameters, the step)."""
  experiment = experiment_of(job)
  model = trainer.build_model(experiment, seed=0, device="cpu")
  if "init" in job:
    model.module.load_state_dict(
        {k: torch.from_numpy(v) for k, v in load_npz(job["init"]).items()})
  t = trainer.Trainer(model, experiment.train, mesh=mesh)
  if "draws" in job:
    draws = load_npz(job["draws"])
    arrays = [torch.from_numpy(draws[k]) for k in ("eps", "time", "include")]
    model.draws = lambda generator: (lambda x0, cfg: tuple(arrays))
  batches = batches_of(job)
  state = t.create_state()
  rows = []
  if "model_dir" in job:
    train_loop = loop.TrainLoop(trainer=t, experiment=experiment,
                                model_dir=job["model_dir"], log_period=1)
    state = train_loop.maybe_resume(state)
    state = train_loop.run((t.shard_batch(b) for b in batches[state.step:]),
                           state, num_steps=job["steps"], seed=job["seed"])
  else:
    for batch in batches[:job["steps"]]:
      state, metrics = t.train_step(state, t.shard_batch(batch), job["seed"])
      rows.append([float(metrics[k]) for k in METRICS])
  params = {k: v.numpy() for k, v in t.full_params().items()}
  return np.asarray(rows, np.float64), params, state.step


METRICS = ("loss", "n_frames", "grad_norm", "loss_per_frame")


def train_job(job, mesh, out):
  rows, params, step = train(job, mesh)
  if mesh.rank == 0:
    np.savez(out, metrics=rows, step=step,
             **{f"params/{k}": v for k, v in params.items()})


def predict(job, mesh):
  """InferenceModel(mesh=).predict on the job's global batch (mesh None:
  unsharded); int8 from a state quantized at `min_dim` (the tiny widths
  are under the default)."""
  experiment = experiment_of(job)
  kwargs = {}
  if job["compute_dtype"] == "int8":
    state = inference.build_model(experiment, device="cpu").module.state_dict()
    kwargs["state_dict"] = quantize.quantize_params(
        inference.cast_params_bf16(state), min_dim=job["min_dim"])
  served = inference.InferenceModel(experiment, device="cpu",
                                    compute_dtype=job["compute_dtype"],
                                    mesh=mesh, **kwargs)
  return served.predict(batches_of(job)[0], seed=3)


def predict_job(job, mesh, out):
  mel = predict(job, mesh)
  if mesh.rank == 0:
    np.savez(out, mel=mel)


def cli_job(job, mesh, out):
  """A CLI's main (the process group is joined already)."""
  del mesh
  if job["cli"] == "train":
    from music_spectrogram_diffusion_tpu_torch.cli import train as cli
  else:
    from music_spectrogram_diffusion_tpu_torch.cli import distill as cli
  cli.main(job["argv"])
  if multihost.is_primary():
    np.savez(out, ok=True)


def round_trip_tensors():
  """Full tensors of every dtype a state holds, -0.0, NaN and inf among
  the floats, shaped to split on either dim."""
  g = torch.Generator().manual_seed(5)
  f32 = torch.randn(8, 12, generator=g)
  f32[0, :4] = torch.tensor([-0.0, float("nan"), float("inf"), -1e-45])
  return {"f32": f32, "bf16": torch.randn(4, 8, generator=g).bfloat16(),
          "int8": torch.randint(-127, 128, (8, 4), generator=g,
                                dtype=torch.int8),
          "scale": torch.rand(12, generator=g), "whole": torch.arange(6.0)}


ROUND_TRIP_SPECS = {"f32": ("data", "model"), "bf16": (None, "model"),
                    "int8": ("model", None), "scale": ("model",)}


def round_trip_job(job, mesh, out):
  """shard_pytree, then gather_pytree, of round_trip_tensors."""
  del job
  tree = round_trip_tensors()
  back = mesh_lib.gather_pytree(
      mesh_lib.shard_pytree(tree, ROUND_TRIP_SPECS, mesh), ROUND_TRIP_SPECS,
      mesh)
  if mesh.rank == 0:
    np.savez(out, **{k: v.view(torch.int16).numpy() if v.dtype ==
                     torch.bfloat16 else v.numpy() for k, v in back.items()})


JOBS = {"train": train_job, "predict": predict_job, "cli": cli_job,
        "round_trip": round_trip_job}


def main(argv):
  rank, world, rendezvous, mesh_spec, jobs_path, out_dir = argv
  torch.set_num_threads(1)
  multihost.initialize(init_method=f"file://{rendezvous}",
                       num_processes=int(world), process_id=int(rank),
                       backend="gloo", device="cpu")
  with open(jobs_path) as f:
    jobs = json.load(f)
  try:
    for job in jobs:
      mesh = multihost.global_mesh(*mesh_lib.parse_mesh(mesh_spec))
      JOBS[job["kind"]](job, mesh, os.path.join(out_dir,
                                                job["name"] + ".npz"))
  finally:
    multihost.shutdown()


if __name__ == "__main__":
  main(sys.argv[1:])
