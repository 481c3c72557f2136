import sys

from whisper_tpu_torch.bench.cli import main

sys.exit(main())
