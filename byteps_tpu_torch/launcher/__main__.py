import sys

from byteps_tpu_torch.launcher.launch import main

if __name__ == "__main__":
    sys.exit(main())
