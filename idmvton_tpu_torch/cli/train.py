"""Fine-tuning CLI of the PyTorch port (reference: train_xl.py main(),
:301-797).

Counterpart of ``idmvton_tpu/cli/train.py``, with the same flags and
defaults plus ``--device``: trains TryonNet (+ Resampler) with everything
else frozen, DDPM noise-prediction MSE, optional min-SNR, remat,
AdamW(1e-5), grad clip 1.0, periodic pipeline checkpoints and resumable
train states.

  python -m idmvton_tpu_torch.cli.train --data_dir /path/VITON-HD \\
      --output_dir ckpt_out --train_batch_size 6 --max_steps 1000 \\
      [--micro | --tiny] [--device cpu]
  torchrun --nproc_per_node N -m idmvton_tpu_torch.cli.train ... [--zero1]

It runs on the card (``--device cuda``, the default) unless asked for the
CPU. Under ``torchrun`` (or inside a process group the caller set up) it
trains data-parallel over every rank (``parallel/``: NCCL between cards,
gloo between CPU processes): the global batch is ``--train_batch_size``
x ranks, as in the JAX CLI, each rank loads only its rows of each global
batch of one shared ``BatchLoader`` order (``shard=``), the gradients
are averaged, and rank 0 alone logs, evaluates and writes checkpoints
(img/s counts the global batch).
``--zero1`` partitions the optimizer moments over the ranks (ZeRO-1); on
one rank it changes nothing, as in the JAX CLI on one device; a
checkpoint gathers them first, so a state saved at N ranks resumes at
any count. ``state.step`` counts micro-steps (one a batch); the
logging, eval and checkpoint cadence and ``--max_steps`` count optimizer
steps, which advance once an accumulation boundary, like the reference's
global_step (train_xl.py:744-747). A checkpoint writes the trained stack
with ``save_pipeline`` (``step_{n}/``) and the train state with
``save_train_state`` (``--state_dir``, default ``output_dir/state``);
``--resume_from_checkpoint DIR`` continues from DIR's newest state.
"""

from __future__ import annotations

import argparse
import os
import time

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="idmvton_tpu_torch fine-tuning")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_dir", default="ckpt_out")
    p.add_argument("--pretrained", default=None)
    p.add_argument("--diffusers", action="store_true")
    p.add_argument("--tokenizer_dir", default=None)
    p.add_argument("--width", type=int, default=768)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--train_batch_size", type=int, default=6,
                   help="per-device batch (reference: 6, train_xl.sh)")
    p.add_argument("--gradient_accumulation_steps", type=int, default=1,
                   help="average gradients over N micro-batches before each "
                        "optimizer step (reference train_xl.py:265,491)")
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--weight_decay", type=float, default=1e-2)
    p.add_argument("--adam_beta1", type=float, default=0.9,
                   help="AdamW beta1 (reference train_xl.py:283)")
    p.add_argument("--adam_beta2", type=float, default=0.999,
                   help="AdamW beta2 (reference train_xl.py:284)")
    p.add_argument("--adam_epsilon", type=float, default=1e-8,
                   help="AdamW epsilon (reference train_xl.py:286)")
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--snr_gamma", type=float, default=None)
    p.add_argument("--optimizer", default="adamw",
                   choices=["adamw", "adamw8bit", "adafactor"],
                   help="adamw8bit = int8-moment AdamW (reference "
                        "--use_8bit_adam, train_xl.py:412-420)")
    p.add_argument("--eval_steps", type=int, default=None,
                   help="run try-on inference on one test batch every N "
                        "steps, saving {step}_{i}_test.jpg to output_dir "
                        "(reference train_xl.py:492-594)")
    p.add_argument("--num_inference_steps", type=int, default=30)
    p.add_argument("--guidance_scale", type=float, default=2.0)
    p.add_argument("--test_batch_size", type=int, default=2)
    p.add_argument("--no_aug", action="store_true",
                   help="disable color-jitter/affine train augs "
                        "(train_xl.py:152-216)")
    p.add_argument("--num_train_epochs", type=int, default=130)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--checkpointing_steps", type=int, default=1000)
    p.add_argument("--logging_steps", type=int, default=50)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no_remat", action="store_true")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO stage 1: partition the optimizer moments over "
                        "the data-parallel ranks (no effect on one rank)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny random models (smoke tests)")
    p.add_argument("--micro", action="store_true",
                   help="micro random models (mechanics tests: smallest "
                        "stack that exercises every block kind)")
    p.add_argument("--resume_from_checkpoint", default=None,
                   help="train-state dir written by --state_dir")
    p.add_argument("--state_dir", default=None,
                   help="where to save resumable train state (default: "
                        "output_dir/state)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p.parse_args(argv)


def load_models(args, dtype):
    """The stack on ``args.device``: a diffusers tree (``--pretrained DIR
    --diffusers``), the port's pipeline checkpoint (``--pretrained DIR``),
    else random weights from seed 0 (full width, ``--tiny`` or
    ``--micro``)."""
    from idmvton_tpu_torch.pipeline.tryon import TryonModels
    from idmvton_tpu_torch.weights.checkpoint import (
        from_diffusers, load_pipeline,
    )
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA card is visible; pass "
                           "--device cpu to run on the CPU")
    if args.pretrained and args.diffusers:
        return from_diffusers(args.pretrained, dtype, device=device)
    if args.pretrained:
        return load_pipeline(args.pretrained, dtype, device=device)
    return TryonModels.init(0, tiny=args.tiny, micro=args.micro,
                            device=device, dtype=dtype)


def main(argv=None):
    """Trains as the flags say; returns the final ``TrainState``."""
    args = parse_args(argv)
    dtype = torch.bfloat16

    from idmvton_tpu_torch.cli.infer import batch_inputs
    from idmvton_tpu_torch.core.config import SchedulerConfig
    from idmvton_tpu_torch.data.datasets import BatchLoader, VitonHDDataset
    from idmvton_tpu_torch.data.tokenizer import load_tokenizers
    from idmvton_tpu_torch.diffusion.scheduler import DDPMScheduler
    from idmvton_tpu_torch.train.train_step import (
        copy_to_models_, init_train_state, make_optimizer, make_train_step,
    )
    from idmvton_tpu_torch.parallel import mesh as pmesh
    from idmvton_tpu_torch.parallel import zero
    from idmvton_tpu_torch.weights.checkpoint import (
        latest_train_state_step, load_train_state, save_pipeline,
        save_train_state,
    )
    import torch.distributed as dist

    mesh, rank, data = None, 0, (0, 1)
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        args.device = str(pmesh.init_distributed(args.device))
        mesh = pmesh.make_mesh()
        rank = dist.get_rank()
        ax = pmesh.mesh_axis(mesh, pmesh.DATA_AXIS)
        data = (ax.rank, ax.size)
    n_data = data[1]
    models = load_models(args, dtype)
    device = torch.device(args.device)
    sched = DDPMScheduler(SchedulerConfig.train())
    tx = make_optimizer(args.learning_rate, args.weight_decay,
                        b1=args.adam_beta1, b2=args.adam_beta2,
                        eps=args.adam_epsilon,
                        max_grad_norm=args.max_grad_norm,
                        optimizer=args.optimizer,
                        accum_steps=args.gradient_accumulation_steps)
    state = init_train_state(models, tx)
    step_fn = make_train_step(models, sched, tx, snr_gamma=args.snr_gamma,
                              compute_dtype=dtype,
                              remat=not args.no_remat, mesh=mesh)

    state_dir = args.state_dir or os.path.join(args.output_dir, "state")
    if args.resume_from_checkpoint:
        step0 = latest_train_state_step(args.resume_from_checkpoint)
        if step0 is not None:
            state = load_train_state(args.resume_from_checkpoint, state)
            if rank == 0:
                print(f"resumed from {args.resume_from_checkpoint} step "
                      f"{step0}")
    if args.zero1 and n_data > 1:
        state = zero.zero1_state_sharding(state, mesh)
    global_batch = args.train_batch_size * n_data

    tok_dir = args.tokenizer_dir or (args.pretrained if args.diffusers
                                     else None)
    tok1, tok2 = load_tokenizers(
        os.path.join(tok_dir, "tokenizer") if tok_dir else None,
        os.path.join(tok_dir, "tokenizer_2") if tok_dir else None)

    ds = VitonHDDataset(args.data_dir, phase="train",
                        size=(args.height, args.width), hflip_prob=0.5,
                        aug_color_jitter=not args.no_aug,
                        aug_affine=not args.no_aug, seed=args.seed)
    loader = BatchLoader(ds, args.train_batch_size, shuffle=True,
                         drop_last=True, seed=args.seed, shard=data)
    pipe = None

    def run_eval(gstep):
        """In-train try-on eval on one test batch with the current
        TryonNet and Resampler (copied into the serving modules), saving
        {step}_{i}_test.jpg (reference train_xl.py:492-594). On the card
        ``stepwise_generate`` (the JAX CLI's TPU branch), else
        ``jit_generate``."""
        nonlocal pipe
        from idmvton_tpu_torch.data.image import save_image
        from idmvton_tpu_torch.pipeline.tryon import TryonPipeline
        try:
            test_ds = VitonHDDataset(args.data_dir, phase="test",
                                     size=(args.height, args.width))
        except FileNotFoundError:
            print("eval skipped: no test split found")
            return
        copy_to_models_(models, state.trainable, dtype)
        if pipe is None:
            pipe = TryonPipeline(models, DDPMScheduler(
                SchedulerConfig.sdxl_inference()))
        gen = (pipe.stepwise_generate if device.type == "cuda"
               else pipe.jit_generate)(num_steps=args.num_inference_steps,
                                       guidance_scale=args.guidance_scale)
        for batch in BatchLoader(test_ds, args.test_batch_size):
            b = batch["person"].shape[0]
            inputs = batch_inputs(batch, models, tok1, tok2, device, dtype)
            generator = torch.Generator(device=device).manual_seed(args.seed)
            with torch.no_grad():
                images = gen(generator, **inputs)
            save_image(images.float().cpu().numpy(),
                       [os.path.join(args.output_dir, f"{gstep}_{i}_test.jpg")
                        for i in range(b)])
            break  # one batch, like the reference
        print(f"eval images -> {args.output_dir}/{gstep}_*_test.jpg")

    generator = torch.Generator(device=device).manual_seed(args.seed)
    accum = max(1, args.gradient_accumulation_steps)
    micro = state.step
    t0 = time.time()
    for epoch in range(args.num_train_epochs):
        for batch in loader:
            state, metrics = step_fn(state, batch_inputs(
                batch, models, tok1, tok2, device, dtype), generator)
            micro += 1
            if micro % accum:
                continue  # mid-accumulation: params unchanged, no cadence
            gstep = micro // accum
            if gstep % args.logging_steps == 0 and rank == 0:
                ips = (global_batch * accum * args.logging_steps
                       / (time.time() - t0))
                t0 = time.time()
                print(f"epoch {epoch} step {gstep}: loss "
                      f"{float(metrics['loss']):.6f} grad_norm "
                      f"{float(metrics['grad_norm']):.3f} ({ips:.2f} img/s)")
            if args.eval_steps and gstep % args.eval_steps == 0 \
                    and rank == 0:
                os.makedirs(args.output_dir, exist_ok=True)
                run_eval(gstep)
            if gstep % args.checkpointing_steps == 0 or \
                    (args.max_steps and gstep >= args.max_steps):
                whole = zero.gather_state(state)    # every rank takes part
                if rank == 0:
                    out = os.path.join(args.output_dir, f"step_{gstep}")
                    save_pipeline(out, copy_to_models_(
                        models, state.trainable, dtype))
                    save_train_state(state_dir, whole)
                    print(f"checkpoint -> {out} (+ train state "
                          f"{state_dir})")
                if mesh is not None:
                    dist.barrier()
            if args.max_steps and gstep >= args.max_steps:
                return state
    return state


if __name__ == "__main__":
    main()
