"""``python -m deeplearning4j_tpu_torch.ui --file stats.jsonl [--port 9000]``

Serve the training dashboard over an existing stats file (reference
``PlayUIServer.main`` CLI entry, PlayUIServer.java:51).
"""

import argparse
import time

from deeplearning4j_tpu_torch.storage import FileStatsStorage
from deeplearning4j_tpu_torch.ui.server import UIServer


def main(argv=None):
    ap = argparse.ArgumentParser(description="deeplearning4j-tpu training UI (PyTorch port)")
    ap.add_argument("--file", required=True, help="JSON-lines stats file")
    ap.add_argument("--port", type=int, default=9000)
    ap.add_argument("--bind-address", default="127.0.0.1",
                    help="interface to bind (0.0.0.0 exposes remotely)")
    args = ap.parse_args(argv)
    server = UIServer.get_instance(args.port, args.bind_address).attach(
        FileStatsStorage(args.file))
    print(f"UI server at {server.address} (ctrl-c to stop)", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
