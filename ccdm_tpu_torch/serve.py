"""Batched inference serving of the guided samplers (DDIM, or the ancestral
sampler with --sampler ddpm), and of the one-step DMD2-M student
(GeneratorService, python -m ccdm_tpu_torch.serve_dmd), over HTTP.

Counterpart of ccdm_tpu/serve.py, with the same API:

    python -m ccdm_tpu_torch.serve --image_size 64 \
        --model_channels 64 --channel_mult 1_2_2_4_8 --train_amp \
        --pred_objective pred_x0 --serve_port 8600

    GET  /healthz    -> {"status": "ok", "warm": true, "milestone": ...}
    POST /generate   body {"labels": [...in [0,1]...], "cond_scale": 1.5?,
                           "seed": 0?}
                     -> {"images_b64": <base64 npz of uint8 [N,H,W,C] under
                         key 'images'>, "labels": [...], "time_s": ...}

Labels are normalized to [0,1]. Every request is padded to the service's
batch. It runs on the card unless --device cpu is given. It serves the
EMA weights of the port's milestone --serve_milestone N, found under
<root_path>/output/<data_name>_<image_size>/<setting_name>/results as
main.py writes it, or with --serve_milestone 0 the weights drawn from
--seed or a state_dict handed in (e.g. from utils/convert.py). The label
embeddings are the teacher's: the analytic types as main.py builds them, a
resnet-ILI model's nets loaded from <setting folder>/embed_models/, where
main.py trained them. Serving never trains them: without that cache it
raises FileNotFoundError, with no fallback to another embedding. With
--use_Hy each request's labels scale the initial noise by sqrt(H(y)).
With --label_dim > 1 the embeddings are the multi-dim ones main.py built
(--dim_combination, its weights read from embed_models/); requests stay
1-D and take dim 0's embedding, as the JAX service's do.
"""

from __future__ import annotations

import base64
import io
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch


class SamplerService:
    """Owns the model, the diffusion and the lock around the card."""

    def __init__(self, args, max_batch: int = 64, warm: bool = True,
                 max_labels: int = 1024, device: Optional[str] = None,
                 state_dict: Optional[dict] = None):
        from ccdm_tpu_torch.diffusion.gaussian import DiffusionConfig, GaussianDiffusion
        from ccdm_tpu_torch.embedding.resolve import build_label_embedding
        from ccdm_tpu_torch.main import build_model, resolve_label_embed, results_folder
        from ccdm_tpu_torch.training.state import precast_sampling_params
        from ccdm_tpu_torch.utils.device import resolve_device

        self.device = resolve_device(device)
        resolve_label_embed(args)
        setting_folder = os.path.dirname(results_folder(args))
        self.fn_y2h, fn_y2cov = build_label_embedding(args, setting_folder, bundle=None,
                                                      require_cached=True, device=self.device)
        model = build_model(args, args.image_size, args.num_channels)
        self.loaded_milestone: Optional[int] = None
        if args.serve_milestone > 0:
            if state_dict is not None:
                raise ValueError("pass either --serve_milestone or a state_dict, not both")
            model = ema_model_from_milestone(model, results_folder(args), args.serve_milestone)
            self.loaded_milestone = args.serve_milestone
        elif state_dict is not None:
            model.load_state_dict(state_dict)
        model = model.to(self.device, memory_format=torch.channels_last).eval()
        if args.samp_precast_bf16:
            precast_sampling_params(model)
        dcfg = DiffusionConfig(image_size=args.image_size, channels=args.num_channels,
                               timesteps=args.train_timesteps,
                               sampling_timesteps=args.sample_timesteps,
                               objective=args.pred_objective,
                               beta_schedule=args.beta_schedule,
                               ddim_sampling_eta=args.ddim_eta, use_Hy=args.use_Hy,
                               hy_max_log=args.hy_max_log)
        self.diffusion = GaussianDiffusion(model, dcfg, device=self.device, fn_y2cov=fn_y2cov)
        self.max_batch = max_batch
        self.max_labels = max_labels
        self.cond_scale = args.sample_cond_scale
        self.sample_timesteps = args.sample_timesteps
        self.sampler, self.ddim_eta = args.sampler, args.ddim_eta
        self._lock = threading.Lock()  # one card, one sampler at a time
        self.warm = False
        if warm:
            self.generate(np.full((max_batch,), 0.5, np.float32))
            self.warm = True

    def generate(self, labels01: np.ndarray, cond_scale: Optional[float] = None,
                 seed: Optional[int] = None) -> np.ndarray:
        """labels01 [N] in [0,1] -> uint8 images [N,H,W,C]; thread-safe."""
        from ccdm_tpu_torch.training.trainer import sample_given_labels

        labels01 = np.asarray(labels01, np.float32)
        if labels01.ndim != 1 or len(labels01) == 0:
            raise ValueError("labels must be a non-empty 1-D list")
        if len(labels01) > self.max_labels:
            raise ValueError(f"request too large: {len(labels01)} labels "
                             f"(cap {self.max_labels}); split into smaller requests")
        if labels01.min() < 0.0 or labels01.max() > 1.0:
            raise ValueError("labels must be normalized to [0,1]")
        n = len(labels01)
        pad = (-n) % self.max_batch
        padded = np.concatenate([labels01, np.repeat(labels01[-1:], pad)])
        with self._lock:
            images, _ = sample_given_labels(
                self.diffusion, padded, self.fn_y2h, batch_size=self.max_batch,
                denorm=True, cond_scale=self.cond_scale if cond_scale is None else cond_scale,
                sample_timesteps=self.sample_timesteps,
                key_base=1 if seed is None else int(seed),
                sampler=self.sampler, ddim_eta=self.ddim_eta)
        return np.asarray(images[:n], np.uint8)


class GeneratorService:
    """The one-step DMD2-M student over the same HTTP surface: netG(z,
    y2h(y)) in eval mode, one generator forward per batch of a request
    (ccdm_tpu/serve.py:149-243). It serves the generator of the port's
    milestone <setting folder>/dmd_results/model-dmd-<--serve_milestone>,
    where dmd_main.py writes it, and the label embedding of the TEACHER's
    setting folder (--teacher_setting_name, default --setting_name), as
    dmd_main.py builds it, loaded only. (JAX's serve_dmd looks under
    <setting>/results and embeds through --setting_name's folder, so it
    never finds what JAX's dmd_main writes.) A request with cond_scale is
    refused: the one-step student has no guidance pass."""

    def __init__(self, args, max_batch: int = 64, warm: bool = True, max_labels: int = 1024,
                 device: Optional[str] = None):
        from ccdm_tpu_torch.dmd_main import build_gan, dmd_results_folder, setting_folder
        from ccdm_tpu_torch.embedding.resolve import build_label_embedding
        from ccdm_tpu_torch.training.dmd import load_generator
        from ccdm_tpu_torch.utils.ckpt import checkpoint_exists, load_checkpoint
        from ccdm_tpu_torch.utils.device import resolve_device

        self.device = resolve_device(device)
        results, name = dmd_results_folder(args), f"dmd-{args.serve_milestone}"
        if not checkpoint_exists(results, name):
            raise FileNotFoundError(f"DMD milestone {args.serve_milestone} not found under "
                                    f"{results}")
        netG, _ = build_gan(args, args.num_channels, args.image_size)
        self.netG = load_generator(netG, load_checkpoint(results, name)).to(self.device).eval()
        self.loaded_milestone = args.serve_milestone
        self.fn_y2h, _ = build_label_embedding(args, setting_folder(args, teacher=True),
                                               bundle=None, require_cached=True,
                                               device=self.device)
        self.dim_z = args.dim_z
        self.max_batch = max_batch
        self.max_labels = max_labels
        self._lock = threading.Lock()
        self.warm = False
        if warm:
            self.generate(np.full((max_batch,), 0.5, np.float32))
            self.warm = True

    def generate(self, labels01: np.ndarray, cond_scale: Optional[float] = None,
                 seed: Optional[int] = None) -> np.ndarray:
        """labels01 [N] in [0, 1] -> uint8 images [N, H, W, C], one forward a
        batch; batch i draws z from a generator seeded from (seed, i)."""
        from ccdm_tpu_torch.training.dmd import one_step
        from ccdm_tpu_torch.training.trainer import chunk_seed

        if cond_scale is not None:
            raise ValueError("cond_scale is not applicable to the one-step DMD student "
                             "(no classifier-free guidance pass exists)")
        labels01 = np.asarray(labels01, np.float32)
        if labels01.ndim != 1 or len(labels01) == 0:
            raise ValueError("labels must be a non-empty 1-D list")
        if len(labels01) > self.max_labels:
            raise ValueError(f"request too large: {len(labels01)} labels "
                             f"(cap {self.max_labels}); split into smaller requests")
        if labels01.min() < 0.0 or labels01.max() > 1.0:
            raise ValueError("labels must be normalized to [0,1]")
        n = len(labels01)
        padded = np.concatenate([labels01, np.repeat(labels01[-1:], (-n) % self.max_batch)])
        key = 1 if seed is None else int(seed)
        out = []
        with self._lock:
            for i in range(0, len(padded), self.max_batch):
                gen = torch.Generator(device=self.device).manual_seed(chunk_seed(key, i))
                z = torch.randn(self.max_batch, self.dim_z, generator=gen, device=self.device)
                y = torch.from_numpy(padded[i:i + self.max_batch]).to(self.device)
                x = torch.clamp(one_step(self.netG, self.fn_y2h, y, z), 0.0, 1.0)
                out.append((x * 255.0 + 0.5).to(torch.uint8).cpu().numpy())
        return np.concatenate(out, axis=0)[:n]


def ema_model_from_milestone(model, results: str, milestone: int):
    """`model` holding the EMA parameters and BatchNorm statistics of the
    port's milestone (utils/ckpt.py); raises FileNotFoundError without it."""
    from ccdm_tpu_torch.training.state import shadowed_tensors
    from ccdm_tpu_torch.training.trainer import copy_tensors
    from ccdm_tpu_torch.utils.ckpt import load_checkpoint

    tree = load_checkpoint(results, milestone)
    copy_tensors(shadowed_tensors(model), tree["ema_params"] + tree["ema_batch_stats"],
                 "EMA weights")
    return model


def _encode_images(images: np.ndarray) -> str:
    buf = io.BytesIO()
    np.savez_compressed(buf, images=images)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def make_handler(service):
    """The handler of a SamplerService or a GeneratorService."""

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok", "warm": service.warm,
                                  "milestone": service.loaded_milestone})
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/generate":
                return self._reply(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                t0 = time.perf_counter()
                images = service.generate(np.asarray(req["labels"], np.float32),
                                          cond_scale=req.get("cond_scale"),
                                          seed=req.get("seed"))
                self._reply(200, {"images_b64": _encode_images(images),
                                  "labels": list(map(float, req["labels"])),
                                  "time_s": round(time.perf_counter() - t0, 4)})
            except (KeyError, ValueError, TypeError) as e:
                self._reply(400, {"error": str(e)})

        def log_message(self, fmt, *a):  # quiet by default
            pass

    return Handler


def serve(service, port: int, host: str = "127.0.0.1",
          block: bool = True) -> ThreadingHTTPServer:
    """Bind the HTTP server. With `block` serve until interrupted, then
    close; without, return the bound server for the caller to run
    (serve_forever in a thread) and to shutdown() and server_close()."""
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    if block:
        print(f" serving on {host}:{httpd.server_address[1]} "
              f"(milestone={service.loaded_milestone})", flush=True)
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()
    return httpd


def main(argv=None):
    from ccdm_tpu_torch.opts import parse_opts

    args = parse_opts(argv)
    service = SamplerService(args, max_batch=args.samp_batch_size,
                             max_labels=args.serve_max_labels, device=args.device)
    # binds loopback by default; --serve_host 0.0.0.0 is an explicit opt-in
    serve(service, args.serve_port, host=args.serve_host)


if __name__ == "__main__":
    main()
