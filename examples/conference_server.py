"""Runnable example: a G.711 conference server at scale on the native
batched RTP edge — the deployment shape of this framework.

    python examples/conference_server.py --legs 256 --port 5004 \
        --conf-size 4 --seconds 30

Every leg sends RTP (PCMU, SSRC base+index) to --port and receives its
conference mix-minus back at its source address... for this example the
reply address is a single --client host:port (BUNDLE-style multiplexing;
production would track per-SSRC sources).
"""
import argparse
import socket
import sys
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--legs", type=int, default=64)
    ap.add_argument("--port", type=int, default=5004)
    ap.add_argument("--client", default="127.0.0.1:5006")
    ap.add_argument("--conf-size", type=int, default=4)
    ap.add_argument("--ssrc-base", type=lambda v: int(v, 0), default=0x5000)
    ap.add_argument("--seconds", type=int, default=30)
    ap.add_argument("--srtp-seed", default=None,
                    help="hex seed: derive per-leg SRTP master keys "
                         "(AES_CM_128_HMAC_SHA1_80) and protect inline in "
                         "the native edge; the client derives the same "
                         "keys from the same seed")
    ap.add_argument("--gpu", action="store_true",
                    help="run the graph on the NVIDIA GPU (fails without "
                         "one; default: CPU)")
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cuda" if args.gpu else "cpu")

    import numpy as np
    import jax.numpy as jnp
    from mediastreamer2_tpu.core.factory import Factory
    from mediastreamer2_tpu.models.audio_stream import AudioStreamBatch

    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("0.0.0.0", args.port))
    sock.setblocking(False)
    host, port = args.client.split(":")

    server = AudioStreamBatch(Factory(), args.legs, conference=True)
    srtp_keys = None
    if args.srtp_seed:
        rng = np.random.default_rng(int(args.srtp_seed, 16))
        srtp_keys = [(rng.bytes(16), rng.bytes(14))
                     for _ in range(args.legs)]
    server.enable_batch_edge(rx_sock=sock, tx_sock=sock,
                             remote=(host, int(port)),
                             ssrc_base=args.ssrc_base,
                             srtp_keys=srtp_keys)
    server.ticker.params["conf"]["group_id"] = jnp.asarray(
        np.arange(args.legs, dtype=np.int32) // args.conf_size)
    server.ticker.warm_up()
    print(f"conference server: {args.legs} legs on :{args.port}, "
          f"groups of {args.conf_size}, replies to {args.client}")
    server.run(args.seconds * 100)
    print("stats leg0:", server._edge_rx.stats(0))
    print("ticker:", server.ticker.stats)


if __name__ == "__main__":
    main()
