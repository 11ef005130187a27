"""Training entry point: `python -m saunet_tpu_torch.cli.train <flags>`
(counterpart of saunet_tpu/cli/train.py, same flags plus `--device`).

The epoch loop: train steps with the augmentation on the device (the warp
kernel), per-epoch evaluation with the last batch padded and masked,
per-class IoU, the cosine LR schedule, `BestIoUPolicy` checkpoints
(`state_epoch_<N>.pt`), `best.json` and `--resume`, which takes up the
newest epoch of the run directory, whether the port wrote it
(`state_epoch_<N>.pt`) or the JAX package (`state_epoch_<N>.msgpack`:
weights, batch statistics, optax moments and step), and goes on at epoch
N + 1. `--weights_unet` warm-starts the weights alone from a port
checkpoint or state_dict (`.pt`) or a JAX package checkpoint (`.msgpack`).
`--encoder_concat` picks the dense blocks' train layout (models/densenet.py:
'chain', 'buffer' or 'fused'; 'auto' is 'chain', as in the JAX CLI). It
runs on the card (`--device cuda`, the default; a missing card is an
error) or, when asked, on the CPU. The port has one stream layout:
`--stream_impl` is accepted and runs the same math.

Data parallel: under `torchrun --nproc_per_node N -m
saunet_tpu_torch.cli.train ... [--space S]` each rank takes a card
(`parallel.init_data_parallel`: NCCL when each rank has its own, gloo when
ranks share one) and the run is the JAX package's run on a ('data',
'space') mesh of N / S x S devices: the global batch is
`--batch_size_per_device` x N / S, every rank samples the same global
batches and takes its samples (and, with S > 1, its rows of their
images: `--space` splits the image H axis), and the step is the
global-batch step (synced BatchNorm, the global batch's loss and
augmentation). Validation runs each rank's rows of each global batch and
sums the IoU counts over the ranks. Rank 0 alone prints and writes
checkpoints. On more than one node each 'data' index samples its own
shard (`DistributedShardSampler`). Without torchrun it is a one-device
run.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import time

import numpy as np
import torch
import torch.distributed as dist

from ..data import (
    ACDCDataset,
    ArrayDataLoader,
    RandomSampler,
    edge_ground_truth,
    make_augment_fn,
    normalize_for_eval,
    to_device,
)
from ..data.loader import DistributedShardSampler
from ..models import build_unet
from ..parallel.mesh import (
    in_launched_rank,
    init_data_parallel,
    shard_batch,
    shard_rows,
    validate_spatial_partition,
)
from ..train import (
    BestIoUPolicy,
    cosine_epoch_schedule,
    create_optimizer,
    create_train_state,
    intersection_and_union,
    make_eval_step,
    make_train_step,
    restore_checkpoint,
    restore_params_only,
    save_checkpoint,
)
from ..train.state import resolve_device
from ..utils import AverageMeter


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="SAUNet (PyTorch) training")
    # model
    p.add_argument("--id", default="baseline",
                   help="name identifying the model")
    p.add_argument("--unet_arch", default="saunet")
    p.add_argument("--weights_unet", default="",
                   help="checkpoint to warm-start weights from (.pt, or "
                        "the JAX package's .msgpack)")
    p.add_argument("--pretrained", default="",
                   help="torchvision densenet121 state_dict (.pth, or the "
                        ".npz that saunet_tpu_torch.cli.ingest_pretrained "
                        "writes) to load into the encoder")
    # paths
    p.add_argument("--data-root", dest="data_root", type=str,
                   default=os.getenv("DATA_ROOT", ""))
    p.add_argument("--series-file", dest="series_file", type=str, default="")
    p.add_argument("--ckpt", default="./ckpt")
    # optimization
    p.add_argument("--batch_size_per_device", "--batch_size_per_gpu",
                   dest="batch_size_per_device", default=10, type=int)
    p.add_argument("--num_epoch", default=120, type=int)
    p.add_argument("--start_epoch", default=1, type=int)
    p.add_argument("--optimizer", default="radam",
                   choices=["sgd", "adam", "radam"])
    p.add_argument("--lr_encoder", default=1e-4, type=float)
    p.add_argument("--beta1", default=0.9, type=float)
    p.add_argument("--weight_decay", default=1e-4, type=float)
    p.add_argument("--fix_bn", action="store_true")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    # data
    p.add_argument("--num_class", default=4, type=int)
    p.add_argument("--k_split", default=1, type=int)
    p.add_argument("--crop_size", default=256, type=int)
    p.add_argument("--stream_impl", default="auto",
                   choices=["auto", "xla", "packed"],
                   help="accepted; the port has one shape-stream layout")
    p.add_argument("--encoder_concat", default="auto",
                   choices=["auto", "chain", "buffer", "fused"],
                   help="dense-block train layout; auto: chain")
    p.add_argument("--no_deform", action="store_true",
                   help="disable elastic deformation")
    p.add_argument("--slice_cache", default="",
                   help="dir to memoise host-side volume preprocessing")
    # misc
    p.add_argument("--seed", default=304, type=int)
    p.add_argument("--space", default=1, type=int,
                   help="spatial-parallel mesh axis size (ranks that split "
                        "each image's rows)")
    p.add_argument("--resume", action="store_true",
                   help="resume exactly (weights, optimizer, step) from the "
                        "latest checkpoint in the run's ckpt dir")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cuda' (default) needs a card")
    args = p.parse_args(argv)
    validate_spatial_partition(args.crop_size, args.space)

    n_dev = int(os.environ["WORLD_SIZE"]) if in_launched_rank() else 1
    if n_dev % args.space:
        raise ValueError(f"--space {args.space} does not divide the "
                         f"{n_dev} rank(s)")
    args.batch_size = args.batch_size_per_device * (n_dev // args.space)
    args.id += f"-{args.unet_arch}-ndev{n_dev}-batchSize{args.batch_size}"
    args.id += f"-LR_unet{args.lr_encoder}-epoch{args.num_epoch}"
    args.ckpt = os.path.join(args.ckpt, args.id)
    return args


def _latest_checkpoint(ckpt_dir):
    """(path, epoch) of the newest state_epoch_N.pt or
    state_epoch_N.msgpack (the port's file where both hold epoch N), or
    None."""
    if not os.path.isdir(ckpt_dir):
        return None
    found = []
    for f in os.listdir(ckpt_dir):
        m = re.match(r"state_epoch_(\d+)\.(pt|msgpack)$", f)
        if m:
            found.append((int(m.group(1)), m.group(2) == "pt", f))
    if not found:
        return None
    epoch, _, f = max(found)
    return os.path.join(ckpt_dir, f), epoch


def batches(n, batch_size, rng=None, drop_last=True):
    idx = np.arange(n)
    if rng is not None:
        rng.shuffle(idx)
    end = n - (n % batch_size) if drop_last else n
    for i in range(0, end, batch_size):
        yield idx[i:i + batch_size]


def evaluate(eval_step, state, images, labels, batch_size, num_class,
             mesh=None):
    """Batched validation pass: the last batch is padded by repeating its
    last slice and the padding is masked out of the loss; histogram IoU
    is accumulated over the real slices. With `mesh`, `batch_size` is the
    global batch: each rank runs its rows of each batch (`eval_step` from
    `make_eval_step(mesh=mesh)`; on a 'space' axis its rows of their
    images, normalised and given their edge targets whole first), and the
    IoU counts are summed over the ranks."""
    inter = np.zeros(num_class)
    union = np.zeros(num_class)
    loss_meter = AverageMeter()
    dev = state.device
    for sel in batches(len(images), batch_size, drop_last=False):
        pad = batch_size - len(sel)
        sel_p = np.concatenate([sel, np.repeat(sel[-1:], pad)]) if pad else sel
        host = {"image": images[sel_p],
                "label": labels[sel_p].astype(np.int32),
                "valid": (np.arange(len(sel_p)) < len(sel)).astype(
                    np.float32)}
        if mesh is None:
            rows = slice(0, len(sel_p))
            mine = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        else:
            rows = shard_rows(len(sel_p), mesh)
            mine = shard_batch(host, mesh, split_rows=False)
        lab = mine["label"]
        batch = {"image": normalize_for_eval(mine["image"]), "label": lab,
                 "edge": edge_ground_truth(lab, num_class),
                 "valid": mine["valid"]}
        if mesh is not None and mesh.space > 1:
            lo, hi = mesh.rows(lab.shape[1])
            batch = {k: v if v.dim() == 1 else v[:, lo:hi].contiguous()
                     for k, v in batch.items()}
        _, preds, metrics = eval_step(state, batch)
        real = max(0, min(len(sel) - rows.start, len(preds)))
        preds = preds[:real].cpu().numpy()
        lab = batch["label"][:real].cpu().numpy()
        loss_meter.update(float(metrics["loss"]), weight=len(sel))
        for j in range(real):
            i_, u_ = intersection_and_union(preds[j], lab[j], num_class)
            inter += i_
            union += u_
    if mesh is not None:
        counts = torch.from_numpy(np.stack([inter, union])).to(dev)
        dist.all_reduce(counts, group=mesh.group)
        inter, union = counts.cpu().numpy()
    iou = inter / (union + 1e-10)
    return iou[1:], loss_meter.average()


def _quiet(*args, **kwargs):
    """`print` on ranks other than 0."""


def main(argv=None):
    args = parse_args(argv)
    owns_group = in_launched_rank() and not dist.is_initialized()
    mesh = (init_data_parallel(args.device, args.space)
            if in_launched_rank() else None)
    log = _quiet if mesh is not None and mesh.rank else print
    log("Input arguments:")
    for k, v in sorted(vars(args).items()):
        log(f"  {k:24} {v}")

    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    device = resolve_device(args.device) if mesh is None else mesh.device
    # the same generator state on every rank: each draws the global
    # batch's augmentation and warps its own rows
    gen = torch.Generator(device=device).manual_seed(args.seed)
    log(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else "")
          + (f", rank 0 of {mesh.world} as ('data' {mesh.data}, 'space' "
           f"{mesh.space})" if mesh is not None else ""))

    # --- data ---------------------------------------------------------
    series = args.series_file or None
    ds_train = ACDCDataset(args.data_root, split="train", series_file=series,
                           k_split=args.k_split, target_size=args.crop_size)
    ds_val = ACDCDataset(args.data_root, split="val", series_file=series,
                         k_split=args.k_split, target_size=args.crop_size)
    log(f"loading {len(ds_train)} train / {len(ds_val)} val volumes ...")
    t0 = time.time()
    cache = args.slice_cache or None
    train_imgs, train_labs, _ = ds_train.load_slices(cache_dir=cache)
    val_imgs, val_labs, _ = ds_val.load_slices(cache_dir=cache)
    log(f"  {len(train_imgs)} train / {len(val_imgs)} val slices "
          f"({time.time() - t0:.1f}s)")

    steps_per_epoch = max(len(train_imgs) // args.batch_size, 1)

    # --- model / optimizer -------------------------------------------
    encoder_concat = ("chain" if args.encoder_concat == "auto"
                      else args.encoder_concat)
    model = build_unet(num_class=args.num_class, arch=args.unet_arch,
                       dtype=args.dtype, encoder_concat=encoder_concat)
    schedule = cosine_epoch_schedule(args.lr_encoder, args.num_epoch,
                                     steps_per_epoch)
    tx = create_optimizer(args.optimizer, schedule, beta1=args.beta1,
                          weight_decay=args.weight_decay)
    if args.pretrained:
        from ..models.densenet import load_pretrained_encoder
        load_pretrained_encoder(args.pretrained, model)
        log(f"Loaded pretrained encoder weights from {args.pretrained}.")
    if args.weights_unet:
        restore_params_only(args.weights_unet, model)
        log("Loaded pretrained UNet weights.")
    state = create_train_state(model, tx, device, mesh=mesh)
    if args.resume:
        latest = _latest_checkpoint(args.ckpt)
        if latest:
            restore_checkpoint(latest[0], state)
            args.start_epoch = latest[1] + 1
            log(f"Resumed from {latest[0]} (epoch {latest[1]}); "
                  f"continuing at epoch {args.start_epoch}")

    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: {args.unet_arch}  params: {n_params / 1e6:.2f}M")

    augment = make_augment_fn(num_classes=args.num_class,
                              enable_deform=not args.no_deform)
    train_step = make_train_step(model, tx, num_class=args.num_class,
                                 augment_fn=augment, fix_bn=args.fix_bn,
                                 mesh=mesh)
    eval_step = make_eval_step(model, num_class=args.num_class, mesh=mesh)

    # --- epoch loop ---------------------------------------------------
    history = {"train": {"epoch": [], "loss": [], "acc": [], "jaccard": []},
               "val": {"epoch": [], "iou": [], "loss": []}}
    policy = BestIoUPolicy()
    shuffle_rng = np.random.RandomState(args.seed)
    os.makedirs(args.ckpt, exist_ok=True)

    if mesh is not None and mesh.nodes > 1:
        # each 'data' index samples its own shard: its batches are its
        # samples (whole images: the augmentation keeps each rank's rows)
        sampler = DistributedShardSampler(len(train_imgs),
                                          num_shards=mesh.data,
                                          shard_id=mesh.data_index,
                                          seed=args.seed)
        batch_size, place = args.batch_size_per_device, to_device(device)
    else:
        # every rank samples the same global batches and takes its samples
        sampler = RandomSampler(len(train_imgs), shuffle_rng)
        batch_size = args.batch_size
        place = (to_device(device) if mesh is None
                 else lambda b: shard_batch(b, mesh, split_rows=False))
    loader = ArrayDataLoader(
        {"image": train_imgs, "label": train_labs.astype(np.int32)},
        batch_size=batch_size, sampler=sampler, place=place, prefetch=2)

    for epoch in range(args.start_epoch, args.num_epoch + 1):
        if isinstance(sampler, DistributedShardSampler):
            sampler.set_epoch(epoch)
        loss_m, acc_m = AverageMeter(), AverageMeter()
        jac_m = AverageMeter()
        time_m = AverageMeter()
        tic = time.time()
        for it, batch in enumerate(loader):
            state, metrics = train_step(state, batch, gen)
            loss_m.update(float(metrics["loss"]))
            acc_m.update(float(metrics["acc"]) * 100)
            jac_m.update(metrics["jaccard"].cpu().numpy() * 100)
            time_m.update(time.time() - tic)
            tic = time.time()
            if (it + 1) % 10 == 0:
                lr_now = float(schedule(state.step - 1))
                jac = np.round(jac_m.average(), 2)
                log(f"Epoch: [{epoch}/{args.num_epoch}] "
                      f"Iter: [{it + 1}/{steps_per_epoch}] "
                      f"Time: {time_m.average():.2f}s lr: {lr_now:.6f} "
                      f"Acc: {acc_m.average():.2f} "
                      f"Loss: {loss_m.average():.4f} Jaccard: {jac}")

        history["train"]["epoch"].append(epoch)
        history["train"]["loss"].append(loss_m.average())
        history["train"]["acc"].append(acc_m.average())
        history["train"]["jaccard"].append(
            float(np.mean(jac_m.average())))

        iou, val_loss = evaluate(eval_step, state, val_imgs, val_labs,
                                 args.batch_size, args.num_class, mesh)
        for i, v in enumerate(iou, start=1):
            log(f"class [{i}], IoU: {v:.4f}")
        log(f"val loss: {val_loss:.4f}")
        history["val"]["epoch"].append(epoch)
        history["val"]["iou"].append([float(v) for v in iou])
        history["val"]["loss"].append(float(val_loss))

        if policy.update(epoch, iou, args.num_epoch):
            path = save_checkpoint(args.ckpt, f"epoch_{epoch}", state,
                                   history)
            log(f"Saved checkpoint {path}")

    if mesh is None or mesh.rank == 0:
        with open(os.path.join(args.ckpt, "best.json"), "w") as f:
            json.dump({**policy.best, **policy.best_epoch}, f, indent=2)
    log("Training Done!")
    if owns_group:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
