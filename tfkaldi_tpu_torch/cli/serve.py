"""Decode-service entry point of the port: load the trained net once, then serve.

Port of :mod:`tfkaldi_tpu.cli.serve`. Spool mode (default) watches a
directory for featdir jobs (the hybrid recipe's likelihoods, or the text of
a CTC, transducer or attention model)::

    python -m tfkaldi_tpu_torch.cli.serve --config config.cfg \\
        --watch /spool/in --out /spool/out [--once] [--poll 1.0] [--device cuda]

Jobs are featdir directories dropped under ``--watch`` (contract in
tfkaldi_tpu_torch/serve.py). ``--once`` processes the current spool and
exits; by default the service runs until killed.

Streaming mode (``--stream``) serves the CTC and transducer recipes over a
socket: float32 PCM chunks in, a partial transcript a chunk, the final on
finish (the wire protocol of tfkaldi_tpu_torch/serve.py, the JAX package's
byte for byte). Every connection shares one batched transcriber
(``MultiStreamServer``; ``--slots`` bounds the concurrent streams)::

    python -m tfkaldi_tpu_torch.cli.serve --config config.cfg --stream \\
        [--host 127.0.0.1] [--port 0] [--slots 16] [--chunk-size 1600] \\
        [--rate 16000] [--beam-width N] [--endpoint] [--port-file F] [--device cuda]

CMVN uses the training corpus' pooled stats (live streams have no speaker
statistics); ``apply_cmvn = False`` in ``[dnn-features]`` turns it off as in
the offline pipeline.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from configparser import ConfigParser

log = logging.getLogger("tfkaldi_tpu_torch.serve")


def main(argv=None, stop=None) -> int:
    """``stop`` (optional ``() -> bool``) is polled by the streaming accept
    loop, so an embedding program can shut the server down; the CLI itself
    runs until killed."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", required=True)
    parser.add_argument("--watch", help="spool input dir (spool mode)")
    parser.add_argument("--out", help="spool output dir (spool mode)")
    parser.add_argument("--once", action="store_true", help="process the current spool and exit")
    parser.add_argument("--poll", type=float, default=1.0)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--stream", action="store_true", help="serve a streaming socket instead of the spool")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--slots", type=int, default=None,
                        help="concurrent streams sharing the batched transcriber (default "
                             "MultiStreamServer.DEFAULT_SLOTS, 16)")
    parser.add_argument("--chunk-size", type=int, default=1600, help="max audio samples per client chunk")
    parser.add_argument("--rate", type=int, default=16000, help="PCM sample rate the clients stream at")
    parser.add_argument("--beam-width", type=int, default=None, help="override the config's beam width")
    parser.add_argument("--endpoint", action="store_true",
                        help="finish utterances server-side on the default endpoint rules (CTC)")
    parser.add_argument("--port-file", help="write 'host port' here once bound (useful with --port 0)")
    parser.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = parser.parse_args(argv)

    config = ConfigParser()
    if not config.read(args.config):
        log.error("cannot read config %s", args.config)
        return 1

    from tfkaldi_tpu_torch.cli.main import featdir, resolve_labels
    from tfkaldi_tpu_torch.io import ArkReader
    from tfkaldi_tpu_torch.nnet import Nnet

    # input dim from the training featdir (same rule as cli.main)
    train_featdir = featdir(config, "train", "dnn-features")
    with ArkReader(os.path.join(train_featdir, "feats.scp")) as reader:
        input_dim = reader.read_utt_data(0).shape[1]
    coder, num_labels = resolve_labels(config)
    nnet = Nnet(config, input_dim, num_labels, device=args.device)

    if args.stream:
        return _stream(args, config, nnet, coder, train_featdir, stop)
    if not args.watch or not args.out:
        parser.error("spool mode needs --watch and --out (or pass --stream)")

    from tfkaldi_tpu_torch.serve import DecodeService

    service = DecodeService(nnet, args.watch, args.out, coder=coder, batch_size=args.batch_size)
    if args.once:
        log.info("processed %d job(s)", service.process_pending())
    else:
        service.run(poll_seconds=args.poll)
    return 0


def _stream(args, config, nnet, coder, train_featdir: str, stop) -> int:
    from tfkaldi_tpu_torch.cli.main import cmvn_path
    from tfkaldi_tpu_torch.decode.endpoint import EndpointConfig
    from tfkaldi_tpu_torch.serve import MultiStreamServer, build_streaming_transcriber, global_cmvn

    cmvn = global_cmvn(train_featdir) if cmvn_path(config, train_featdir) else None
    transcriber = build_streaming_transcriber(
        nnet, coder, args.rate, dict(config["dnn-features"]), cmvn=cmvn, beam_width=args.beam_width,
        endpoint_config=EndpointConfig() if args.endpoint else None)
    slots = MultiStreamServer.DEFAULT_SLOTS if args.slots is None else args.slots
    server = MultiStreamServer(transcriber, num_slots=slots, chunk_size=args.chunk_size, host=args.host,
                               port=args.port)
    try:
        # port 0 binds an ephemeral port: print the address clients need
        print(f"streaming on {server.host}:{server.port}", flush=True)
        if args.port_file:
            with open(args.port_file, "w") as f:
                f.write(f"{server.host} {server.port}\n")
        log.info("streaming server: %s:%d, %d slots, chunk %d samples @ %d Hz, %s", server.host, server.port,
                 slots, args.chunk_size, args.rate, nnet.device)
        server.serve_forever(stop=stop or (lambda: False))
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
