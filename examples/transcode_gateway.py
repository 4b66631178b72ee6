"""Runnable example: a ulaw@8k -> G.722@16k transcoding gateway
(the B2BUA shape; audio_stream_start_from_io parity).

    python examples/transcode_gateway.py --legs 16 \
        --in-port 5004 --out 127.0.0.1:5008 --seconds 30
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--legs", type=int, default=16)
    ap.add_argument("--in-port", type=int, default=5004)
    ap.add_argument("--out", default="127.0.0.1:5008")
    ap.add_argument("--seconds", type=int, default=30)
    ap.add_argument("--gpu", action="store_true",
                    help="run the graph on the NVIDIA GPU (fails without "
                         "one; default: CPU)")
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cuda" if args.gpu else "cpu")

    from mediastreamer2_tpu.core.factory import Factory
    from mediastreamer2_tpu.models.transcode import TranscodeBatch
    from mediastreamer2_tpu.net.rtp import UdpTransport

    host, port = args.out.split(":")
    tc = TranscodeBatch(Factory(), args.legs, codec_in="ulaw", rate_in=8000,
                        codec_out="g722", rate_out=16000)
    for leg in range(args.legs):
        rx = UdpTransport(local_port=args.in_port + 2 * leg)
        tx = UdpTransport(remote=(host, int(port) + 2 * leg))
        tc.set_transports(leg, rx=rx, tx=tx)
    print(f"gateway: {args.legs} legs, ulaw@8k :{args.in_port}+2n -> "
          f"g722@16k {args.out}+2n")
    tc.run(args.seconds * 100)


if __name__ == "__main__":
    main()
