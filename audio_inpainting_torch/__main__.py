from .cli.main import main

raise SystemExit(main())
