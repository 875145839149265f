import sys

from cardbench.harness import main

sys.exit(main())
