"""Decode-service entry point of the port: load the trained net once, then serve a spool.

Port of the spool mode of :mod:`tfkaldi_tpu.cli.serve` (the hybrid recipe's
likelihoods, or the text of a CTC, transducer or attention model)::

    python -m tfkaldi_tpu_torch.cli.serve --config config.cfg \\
        --watch /spool/in --out /spool/out [--once] [--poll 1.0] [--device cuda]

Jobs are featdir directories dropped under ``--watch`` (contract in
tfkaldi_tpu_torch/serve.py). ``--once`` processes the current spool and
exits; by default the service runs until killed. The streaming socket mode
(``--stream`` and its flags) is not ported yet: ``python -m
tfkaldi_tpu.cli.serve --stream`` serves it.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from configparser import ConfigParser

log = logging.getLogger("tfkaldi_tpu_torch.serve")


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", required=True)
    parser.add_argument("--watch", help="spool input dir")
    parser.add_argument("--out", help="spool output dir")
    parser.add_argument("--once", action="store_true", help="process the current spool and exit")
    parser.add_argument("--poll", type=float, default=1.0)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args, unknown = parser.parse_known_args(argv)
    if unknown:
        raise NotImplementedError(
            f"{' '.join(unknown)}: not in the port yet (streaming serving is ROADMAP.md, "
            "queue 1, slice 7); use python -m tfkaldi_tpu.cli.serve"
        )
    if not args.watch or not args.out:
        parser.error("spool mode needs --watch and --out")

    config = ConfigParser()
    if not config.read(args.config):
        log.error("cannot read config %s", args.config)
        return 1

    from tfkaldi_tpu_torch.cli.main import featdir, resolve_labels
    from tfkaldi_tpu_torch.io import ArkReader
    from tfkaldi_tpu_torch.nnet import Nnet
    from tfkaldi_tpu_torch.serve import DecodeService

    # input dim from the training featdir (same rule as cli.main)
    with ArkReader(os.path.join(featdir(config, "train", "dnn-features"), "feats.scp")) as reader:
        input_dim = reader.read_utt_data(0).shape[1]
    coder, num_labels = resolve_labels(config)
    nnet = Nnet(config, input_dim, num_labels, device=args.device)
    service = DecodeService(nnet, args.watch, args.out, coder=coder, batch_size=args.batch_size)
    if args.once:
        log.info("processed %d job(s)", service.process_pending())
    else:
        service.run(poll_seconds=args.poll)
    return 0


if __name__ == "__main__":
    sys.exit(main())
