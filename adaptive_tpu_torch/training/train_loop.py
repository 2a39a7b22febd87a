"""The training pipeline stage: epochs, logging, eval, early stop, checkpoints
(counterpart of adaptive_tpu/training/train_loop.py, single device).

Reference parity: main_train (code_src/train.py:16-181) — seeded run, bucket
loader, dual optimizers + ReduceLROnPlateau x2 (stepped at epoch start on the
previous epoch's mean loss, initial 100), CNN fine-tune gating from epoch
opt_fine_tune_cnn_start_epoch+1, loss/perplexity prints every train_log_step,
weight histograms + scalar metrics, per-epoch CIDEr eval on train_eval + val
splits, early stop (patience 6), per-epoch checkpoint named
'cider-%.4f_model-%d' (train.py:176-178), plus mid-epoch checkpoints and
auto-resume.

In a process group of more than one rank (torchrun, main.py) the run is
data-parallel over the config's mesh (parallel/mesh.py), as the JAX
package's mesh branch is: every rank computes the same batch plan and
decodes only its data rank's rows (TrainBatches(process_index=,
process_count=)), the step sums its gradients and BN moments over the data
group (training/step.py), ZeRO-1 shards the moments (opt_state_sharding),
the per-epoch eval decodes over the mesh and scores the whole split on every
rank, and rank 0 writes the checkpoints and the metrics. A batch that does
not divide the data axis raises JAX's multi-process error: each card is a
process here, so JAX's one-process "mesh disabled" case does not arise.
When either optimizer group is L-BFGS the step is training/lbfgs.py's
closure step (train_loop.py:174-177). The random draws (crop, flip, dropout) come from one
torch.Generator on the model's device, seeded from train_random_seed; its
state rides in each checkpoint's manifest under "torch_generator_state" in
place of the JAX package's "rng_key". A JAX checkpoint resumed here restores
everything else and seeds the generator afresh.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from adaptive_tpu_torch.config import LSTM_VARIANTS, unsupported
from adaptive_tpu_torch.data.loader import CocoCaptionDataset, TrainBatches, device_prefetch
from adaptive_tpu_torch.data.vocab import Vocabulary
from adaptive_tpu_torch.models.factory import get_model, resolve_device
from adaptive_tpu_torch.training import checkpoint as ckpt
from adaptive_tpu_torch.training.lbfgs import make_lbfgs_train_step
from adaptive_tpu_torch.parallel.mesh import get_rank, get_world_size, make_mesh
from adaptive_tpu_torch.training.optim import (
    get_lr, make_dual_optimizer, set_lr, shard_opt_state,
)
from adaptive_tpu_torch.training.schedule import ReduceLROnPlateau, early_stop_Ornot
from adaptive_tpu_torch.training.step import make_train_step
from adaptive_tpu_torch.utils.logging import MetricWriter

GEN_KEY = "torch_generator_state"


def main_train(cf, dataset=None, device="cuda", eval_datasets=None, image_source=None):
    """Returns (net, best_cider, best_epoch); net is the trained
    Encoder2Decoder on the device.

    dataset: the train split in place of CocoCaptionDataset over
    cf.train_anno_path's JPEGs (anything TrainBatches takes).
    eval_datasets: {"train_eval": ..., "val": ...}, the per-epoch eval's
    images in place of their JPEGs (coco_eval's dataset=).
    image_source: the reader of those JPEGs (file path -> uint8 HWC array)
    in place of the JPEG decode, for the train split and the evals."""
    if cf.atten_model_name not in LSTM_VARIANTS:  # before any work: the hybrid LM does not train
        raise unsupported(cf.atten_model_name, "training")
    device = resolve_device(device)  # no card: raise before any work
    trained_model_path = cf.train_auto_resume_dir or os.path.join(
        cf.exp_dir or ".", "trained_models"
    )
    os.makedirs(trained_model_path, exist_ok=True)

    vocab = Vocabulary.load(cf.vocab_path)
    cf = cf.replace(vocab_length=len(vocab))

    if cf.train_auto_resume_dir:
        # a checkpoint in the resume dir outranks train_pretrained_model:
        # that is the cold-start base, the resume dir this job's progress
        latest = ckpt.find_latest_checkpoint(cf.train_auto_resume_dir)
        if latest:
            print("auto-resume: found checkpoint", latest)
            cf = cf.replace(train_pretrained=True, train_pretrained_model=latest)
        elif cf.train_pretrained and cf.train_pretrained_model:
            print("auto-resume: no checkpoint yet - starting from",
                  cf.train_pretrained_model)
        else:
            print("auto-resume: no checkpoint in", cf.train_auto_resume_dir, "- fresh start")

    mesh = train_mesh(cf)
    if dataset is None:
        dataset = CocoCaptionDataset(cf.resized_image_dir, cf.train_anno_path, vocab,
                                     image_source)
    loader = TrainBatches(
        dataset, cf.train_batch_size, seed=cf.train_random_seed,
        num_workers=cf.dataloader_num_workers,
        # the same plan on every rank, each decoding its data rank's rows
        # (the model ranks of a data row take the same ones)
        process_index=mesh.data_rank if mesh else 0,
        process_count=mesh.data_size if mesh else 1,
        microbatches=cf.train_grad_accum_steps,
    )

    writer = (MetricWriter(os.path.join(cf.exp_dir or ".", "tensorboard"))
              if get_rank() == 0 else _NoMetrics())

    model, net, start_epoch = get_model(cf, device=device)
    gen = torch.Generator(device=model.device).manual_seed(cf.train_random_seed + 1)
    dual = make_dual_optimizer(net, cf)
    if mesh is not None and cf.opt_state_sharding == "data":
        dual = shard_opt_state(dual, net, mesh)  # ZeRO-1 moments
    ckpt_saver = ckpt.AsyncCheckpointer()

    decoder_sched = ReduceLROnPlateau(
        get_lr(dual, "decoder"), cf.opt_lrdecay_factor, cf.opt_lrdecay_patience,
        threshold=0.02, min_lr=1e-6,
    )  # train.py:57-58
    encoder_sched = ReduceLROnPlateau(
        get_lr(dual, "encoder"), cf.opt_lrdecay_factor, cf.opt_lrdecay_patience,
        threshold=0.02, min_lr=1e-7,
    )  # train.py:59-60

    train_epoch_loss = 100.0  # initial value for the scheduler (train.py:80)

    # mid-epoch resume state (zero/empty for fresh starts and epoch resumes)
    start_step = 0
    resumed_loss_sum: Optional[float] = None
    resumed_n_steps = 0
    global_n_iter = 0
    cider_scores, cider_scores_train_eval = [], []
    best_cider, best_epoch = 0.0, 0
    train_epoch_losses = []

    # full resume: optimizer moments, scheduler progress, generator state,
    # metric histories (the reference resumes weights only, for_wzn:15-17)
    if cf.train_pretrained and cf.train_pretrained_model:
        ckpt_dir = cf.train_pretrained_model
        if os.path.exists(os.path.join(ckpt_dir, "opt.npz")):
            ckpt.restore_opt_state(ckpt_dir, dual, net)  # ZeRO-1: each rank's slices
            print("resumed optimizer state from", ckpt_dir)
        meta = {}
        if os.path.exists(os.path.join(ckpt_dir, "manifest.json")):
            meta = ckpt.load_metadata(ckpt_dir)
        for sched, key_ in ((decoder_sched, "decoder_sched"), (encoder_sched, "encoder_sched")):
            if key_ in meta:
                sched.lr = meta[key_]["lr"]
                sched.best = meta[key_]["best"]
                sched.num_bad_epochs = meta[key_]["num_bad_epochs"]
        train_epoch_loss = meta.get("train_epoch_loss", train_epoch_loss)
        if GEN_KEY in meta:
            # the generator's position: the resumed run's draws are the
            # uninterrupted run's
            gen.set_state(torch.tensor(meta[GEN_KEY], dtype=torch.uint8))
        global_n_iter = int(meta.get("global_n_iter", 0))
        train_epoch_losses = list(meta.get("train_epoch_losses", []))
        cider_scores = list(meta.get("cider_scores", []))
        cider_scores_train_eval = list(meta.get("cider_scores_train_eval", []))
        best_cider = float(meta.get("best_cider", 0.0))
        best_epoch = int(meta.get("best_epoch", 0))
        if meta.get("step_in_epoch"):
            # mid-epoch checkpoint: re-enter the SAME epoch at the saved step
            start_epoch = int(meta["epoch"])
            start_step = int(meta["step_in_epoch"])
            resumed_loss_sum = float(meta["epoch_loss_sum"])
            resumed_n_steps = int(meta["epoch_n_steps"])
            print("mid-epoch resume: epoch %d from step %d" % (start_epoch, start_step))

    if dual.decoder_is_lbfgs or dual.encoder_is_lbfgs:
        train_step = make_lbfgs_train_step(model, dual, cf, mesh)
    else:
        train_step = make_train_step(model, dual, cf, mesh)

    # one shared eval decoder: its prepared weights are re-made when the
    # weights change (prepare_cached) and released after each epoch's eval
    eval_decoder = None
    if cf.train_evalOrnot:
        from adaptive_tpu_torch.decoding import make_beam_decoder, make_greedy_decoder

        eval_decoder = (
            make_beam_decoder(model, cf) if cf.beam_size > 1 else make_greedy_decoder(model, cf)
        )
    eval_datasets = eval_datasets or {}

    total_step = len(loader)
    encoder_opt_flag = False

    def resume_meta():
        """The non-weight resume payload saved with every checkpoint."""
        return {
            "model": cf.atten_model_name,
            "vocab_length": cf.vocab_length,  # the unpadded vocab size
            GEN_KEY: gen.get_state().tolist(),
            "global_n_iter": global_n_iter,
            "train_epoch_losses": train_epoch_losses,
            "cider_scores": cider_scores,
            "cider_scores_train_eval": cider_scores_train_eval,
            "best_cider": best_cider,
            "best_epoch": best_epoch,
            "decoder_sched": vars_of(decoder_sched),
            "encoder_sched": vars_of(encoder_sched),
        }

    for epoch in range(start_epoch, cf.train_num_epochs + 1):
        print("#------------------Training for Epoch %d----------------#" % epoch)
        if epoch > cf.opt_fine_tune_cnn_start_epoch:  # train.py:89-90
            encoder_opt_flag = True
        # the batch plan is a pure function of seed + plan index, pinned to
        # the epoch so that a resumed run replays the same plan
        loader.epoch = epoch - 1
        resuming_mid_epoch = epoch == start_epoch and start_step > 0

        if resuming_mid_epoch:
            # the scheduler already stepped at this epoch's start; the
            # restored optimizer carries the learning rates in effect
            print("learning rate of Decoder is:", get_lr(dual, "decoder"))
            if encoder_opt_flag:
                print("learning rate of Encoder is:", get_lr(dual, "encoder"))
        else:
            # lr scheduling at epoch start on previous epoch's loss (train.py:93)
            new_dlr = decoder_sched.step(train_epoch_loss)
            set_lr(dual, "decoder", new_dlr)
            print("learning rate of Decoder is:", new_dlr)
            writer.add_scalars("learning_rate_per_epoch", {"decoder": new_dlr}, epoch)
            if encoder_opt_flag:
                new_elr = encoder_sched.step(train_epoch_loss)
                set_lr(dual, "encoder", new_elr)
                print("learning rate of Encoder is:", new_elr)
                writer.add_scalars("learning_rate_per_epoch", {"encoder": new_elr}, epoch)

        # the loss sum stays on the device: one host read an epoch (a
        # mid-epoch resume seeds it with the checkpointed partial sum)
        loss_sum = (torch.tensor(resumed_loss_sum, dtype=torch.float32, device=model.device)
                    if resuming_mid_epoch else None)
        n_steps = resumed_n_steps if resuming_mid_epoch else 0
        first_batch = start_step if resuming_mid_epoch else 0
        batches = device_prefetch(loader.iter_from(first_batch), model.device, size=2,
                                  mesh=mesh, local=loader.process_sharded)
        every = cf.train_checkpoint_every_steps
        for i, batch in enumerate(batches, start=first_batch):
            out = train_step(net, batch, gen, encoder_opt_flag)
            loss_sum = out.loss if loss_sum is None else loss_sum + out.loss
            n_steps += 1

            if i % cf.train_log_step == 0:  # train.py:120-125
                loss = float(out.loss)  # sync only on log steps
                print(
                    "Epoch [%d/%d], Step [%d/%d], CrossEntropy Loss: %.4f, Perplexity: %5.4f"
                    % (epoch, cf.train_num_epochs, i, total_step, loss, np.exp(loss))
                )
            if global_n_iter % cf.train_tb_interval_batches == 0:  # train.py:128-138
                writer.add_param_histograms(net, global_n_iter)
                writer.add_scalar(
                    "loss-performance/train loss per batches", float(out.loss), global_n_iter
                )
                if cf.train_tb_lstm_clip_grad:
                    writer.add_scalar(
                        "decoder_norm/decoder_lstm_norm", float(out.lstm_grad_norm), global_n_iter
                    )
            global_n_iter += 1

            if every and (i + 1) % every == 0:  # mid-epoch resume point
                step_meta = resume_meta()
                step_meta.update({
                    "epoch": epoch,
                    "step_in_epoch": i + 1,
                    # an fp32-exact float: the resumed epoch mean equals the
                    # uninterrupted run's
                    "epoch_loss_sum": float(loss_sum),
                    "epoch_n_steps": n_steps,
                    "train_epoch_loss": train_epoch_loss,
                })
                ckpt_saver.save(
                    os.path.join(trained_model_path, ckpt.step_checkpoint_name(epoch, i + 1)),
                    net, dual, metadata=step_meta,
                    prune_before=(epoch, i + 1),  # older '_step-K' dirs, once this is durable
                )

        if n_steps:
            train_epoch_loss = float(loss_sum) / n_steps
        writer.add_scalar("loss-performance/train loss per epoch", train_epoch_loss, epoch)
        print("Train Loss: epoch", epoch, train_epoch_loss)
        train_epoch_losses.append(train_epoch_loss)
        print("Train epoch losses:")
        print(train_epoch_losses)

        cider = 0.0
        if cf.train_evalOrnot:  # train.py:151-174
            from adaptive_tpu_torch.evalcap.coco_eval import coco_eval

            cider_train_eval = coco_eval(
                cf, model, net, epoch=epoch, train_mode=True, vocab=vocab,
                decoder=eval_decoder, dataset=eval_datasets.get("train_eval"),
                image_source=image_source,
            )
            cider_scores_train_eval.append(cider_train_eval)
            print("#---printing train_eval cider_scores---#")
            print(cider_scores_train_eval)

            cider = coco_eval(
                cf, model, net, epoch=epoch, vocab=vocab, decoder=eval_decoder,
                dataset=eval_datasets.get("val"), image_source=image_source,
            )
            cider_scores.append(cider)
            print("#---printing validation cider_scores---#")
            print(cider_scores)

            writer.add_scalars(
                "loss-performance/Cider per epoch",
                {"train": cider_train_eval, "valid": cider},
                epoch,
            )
            # release this epoch's prepared weights: stale once training resumes
            eval_decoder.prepare.clear()
            if cider > best_cider:
                best_cider, best_epoch = cider, epoch
            if early_stop_Ornot(cf, cider_scores, best_cider):
                break

        # per-epoch checkpoint (train.py:176-178) with the resume payload;
        # the file writes overlap the next epoch (AsyncCheckpointer)
        epoch_meta = resume_meta()
        epoch_meta.update({
            "epoch": epoch,
            "cider": cider,
            "train_epoch_loss": train_epoch_loss,
        })
        ckpt_saver.save(
            os.path.join(trained_model_path, ckpt.checkpoint_name(cider, epoch)),
            net, dual, metadata=epoch_meta,
            # this epoch's mid-epoch checkpoints are subsumed once this one is durable
            prune_before=(epoch + 1, 0),
        )

    ckpt_saver.wait()  # all checkpoints durable before the run reports done
    writer.close()
    print("Model of best epoch #: %d with CIDEr score %.2f" % (best_epoch, best_cider))
    if get_rank() == 0:
        figure_loss(cf, train_epoch_losses)
    return net, best_cider, best_epoch


def train_mesh(cf):
    """The training mesh (JAX's train_loop.py:87-102): in a process group of
    more than one rank, the config's mesh, whose data axis must divide the
    batch (and each microbatch); None for one process."""
    if get_world_size() <= 1:
        return None
    mesh = make_mesh(cf)
    data_n = mesh.data_size
    if cf.train_batch_size % data_n:
        raise ValueError(
            "multi-process training requires a mesh: set "
            "train_batch_size (%d) to a multiple of the data axis %d"
            % (cf.train_batch_size, data_n)
        )
    if (cf.train_batch_size // cf.train_grad_accum_steps) % data_n:
        raise ValueError(
            "train_batch_size / train_grad_accum_steps (%d) must be a multiple of "
            "the data axis %d: each microbatch is split over it"
            % (cf.train_batch_size // cf.train_grad_accum_steps, data_n))
    return mesh


class _NoMetrics:
    """The metric writer of a rank other than 0: rank 0 writes them."""

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


def vars_of(sched: ReduceLROnPlateau) -> dict:
    return {"lr": sched.lr, "best": sched.best, "num_bad_epochs": sched.num_bad_epochs}


def figure_loss(cf, train_losses):
    """Loss-curve figure (train.py:264-277 parity; saved once at run end)."""
    if not train_losses or not cf.exp_dir:
        return
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    plt.figure()
    plt.title("Train Losses")
    plt.xlabel("epochs")
    plt.ylabel("losses")
    plt.plot(train_losses, color="b", label="train losses")
    plt.legend()
    plt.savefig(os.path.join(cf.exp_dir, "loss_figure_%d.jpg" % len(train_losses)))
    plt.close()
